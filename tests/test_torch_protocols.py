"""The protocol matrix: the port under every provider, protocol and security
mode against curl_tpu.

The six layouts of tests/test_mpc_sweep.py (TFP/Beaver at 2, 3 and 4
parties, TTP/Beaver at 2 and 3, TFP/replicated at 3) run the same ops on
the same inputs in both packages: add, mul, matmul, square, conv2d, a
public division (the truncation of each layout), lt and eq at
``mpc.compare_bits`` 32, gelu, exp, reciprocal, softmax and max. Each
decoded value is held to curl_tpu's and to the plaintext within the sweep's
own tolerances, and the rounds, bytes and collective calls to curl_tpu's
exactly. tests/test_providers.py's and tests/test_compare_ring.py:79-92's
cases are held the same way, and the tuple forms that ``mpc.lut_fastpath:
False`` and ``mpc.fused_onehot: False`` force; the tiny GPT of tests/test_torch_gpt.py
(1 block) runs under the four layouts that chip_smoke.py's phase 14 runs
at GPT-2's width: rss3, ttp2, tfp3 and active2. curl_tpu's tiny GPT at 3
parties does not finish eagerly in 600 s on a CPU, and its sweep takes
minutes, so its readings come from ``tests/golden/
torch_protocols_reference.npz``, written by

    JAX_PLATFORMS=cpu python3 tests/torch_protocols_reference.py

Single ops of curl_tpu (the sacrifice check, ppermute) run live. The
pieces of the slice have tests of their own: the TTP segment of the Philox
kernel, the replicated product's one launch, the one-hot tuple through the
tuple cache, the forms the gates force, the HE stub and oblivious transfer.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

import curl_tpu  # noqa: E402
from curl_tpu import comm as jcomm  # noqa: E402
from curl_tpu import ring as jring  # noqa: E402
from curl_tpu.parallel import run_parties as jrun  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import comm as tcomm  # noqa: E402
from curl_tpu_torch import ring as tring  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.mpc import get_default_provider  # noqa: E402
from curl_tpu_torch.mpc.primitives import replicated  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_protocols_reference.npz")

# (provider, protocol, parties, active security)
LAYOUTS = {
    "tfp2": ("TFP", "beaver", 2, False),
    "tfp3": ("TFP", "beaver", 3, False),
    "tfp4": ("TFP", "beaver", 4, False),
    "ttp2": ("TTP", "beaver", 2, False),
    "ttp3": ("TTP", "beaver", 3, False),
    "rss3": ("TFP", "replicated", 3, False),
    "active2": ("TFP", "beaver", 2, True),
}
SWEEP = ("tfp2", "tfp3", "tfp4", "ttp2", "ttp3", "rss3")
MODEL_LAYOUTS = ("rss3", "ttp2", "tfp3", "active2")

# tests/test_mpc_sweep.py's tolerances
LIN_TOL = 0.003
LUT_TOL = 0.12


def layout_config(layout):
    """The config keys that select a layout (both packages read the same)."""
    provider, protocol, _, active = LAYOUTS[layout]
    return {"mpc.provider": provider, "mpc.protocol": protocol, "mpc.active_security": active,
            "mpc.compare_bits": 32}


def _sep(rng, shape, scale=3.0):
    """Values pairwise more than 0.01 apart (tests/test_mpc_sweep.py)."""
    vals = rng.permutation(np.arange(-50, 50))[: int(np.prod(shape))]
    return (vals.reshape(shape) * 0.11 * scale).astype(np.float64)


_g = np.random.default_rng(4096)
X = _g.normal(size=(3, 4)) * 2
Y = _g.normal(size=(3, 4)) * 2
W = _g.normal(size=(4, 2))
IMG = _g.normal(size=(1, 2, 5, 5))
KER = _g.normal(size=(3, 2, 3, 3)) * 0.5
SEP_X = _sep(_g, (3, 4))
SEP_Y = np.where(_g.random((3, 4)) < 0.3, SEP_X, _sep(_g, (3, 4), scale=2.9))
POS = _g.uniform(0.5, 8.0, size=(3, 4))
EXP_X = _g.uniform(-3, 2, size=(3, 4))
GELU_X = _g.uniform(-3, 3, size=(3, 4))
SM_X = _sep(_g, (2, 5), scale=0.45)


def _conv2d(x, k):
    out = np.zeros((1, k.shape[0], 5, 5))
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    for i in range(5):
        for j in range(5):
            out[0, :, i, j] = np.tensordot(k, xp[0, :, i:i + 3, j:j + 3], axes=3)
    return out


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _gelu(x):
    return x * (1 + np.vectorize(math.erf)(x / math.sqrt(2))) / 2


# name -> (inputs, op on the encrypted inputs, plaintext, atol, rtol), the
# tolerances tests/test_mpc_sweep.py holds the op to
OPS = {
    "add": ((X, Y), lambda a, b: a + b, lambda a, b: a + b, LIN_TOL, 0),
    "mul": ((X, Y), lambda a, b: a * b, lambda a, b: a * b, 0.02, 0),
    "matmul": ((X, W), lambda a, b: a.matmul(b), lambda a, b: a @ b, 0.05, 0),
    "square": ((X,), lambda a: a.square(), lambda a: a * a, 0.02, 0),
    "conv2d": ((IMG, KER), lambda a, b: a.conv2d(b, padding=1), _conv2d, 0.05, 0),
    "div": ((X,), lambda a: a / 4.0, lambda a: a / 4.0, 0.01, 0),
    "lt": ((SEP_X, SEP_Y), lambda a, b: a.lt(b), lambda a, b: (a < b) * 1.0, 0, 0),
    "eq": ((SEP_X, SEP_Y), lambda a, b: a.eq(b), lambda a, b: (a == b) * 1.0, 0, 0),
    "gelu": ((GELU_X,), lambda a: a.gelu(), _gelu, LUT_TOL, 0),
    "exp": ((EXP_X,), lambda a: a.exp(), np.exp, LUT_TOL, 0.05),
    "reciprocal": ((POS,), lambda a: a.reciprocal(), lambda a: 1 / a, 0.15, 0.05),
    "softmax": ((SM_X,), lambda a: a.softmax(-1), _softmax, 0.18, 0),
    "max": ((SEP_X,), lambda a: a.max(dim=1)[0], lambda a: a.max(1), 0.01, 0),
}

# tests/test_providers.py's cases (op, layout, inputs' seed) and
# tests/test_compare_ring.py:79-92's (lt, eq, ne at 53 elements)
_p = np.random.default_rng(11)
PROVIDER_CASES = {
    "ttp_mul_2pc": ("ttp2", (_p.normal(size=(5,)) * 3, _p.normal(size=(5,)) * 3),
                    lambda a, b: a * b, lambda a, b: a * b, 0.02),
    "ttp_matmul_3pc": ("ttp3", (_p.normal(size=(3, 4)), _p.normal(size=(4, 2))),
                       lambda a, b: a.matmul(b), lambda a, b: a @ b, 0.05),
    "ttp_gelu_3pc": ("ttp3", (np.linspace(-2, 2, 9),), lambda a: a.gelu(), _gelu, 0.05),
    "rss_mul_3pc": ("rss3", (_p.normal(size=(6,)) * 2, _p.normal(size=(6,)) * 2),
                    lambda a, b: a * b, lambda a, b: a * b, 0.05),
    "rss_matmul_3pc": ("rss3", (_p.normal(size=(3, 4)), _p.normal(size=(4, 2))),
                       lambda a, b: a.matmul(b), lambda a, b: a @ b, 0.05),
    "rss_square_3pc": ("rss3", (_p.normal(size=(6,)) * 2,), lambda a: a.square(),
                       lambda a: a * a, 0.05),
    "active_mul_2pc": ("active2", (_p.normal(size=(4,)), _p.normal(size=(4,))),
                       lambda a, b: a * b, lambda a, b: a * b, 0.02),
}
_c = np.random.default_rng(7)
CX = np.concatenate([_c.normal(size=50) * 1000, [0.0, 5000.0, -5000.0]])
CY = np.concatenate([_c.normal(size=50) * 1000, [0.0, -5000.0, 5000.0]])
for _layout in ("tfp3", "rss3", "ttp2"):
    for _name, _op, _plain in (("lt", lambda a, b: a.lt(b), lambda a, b: (a < b) * 1.0),
                               ("eq", lambda a, b: a.eq(b), lambda a, b: (a == b) * 1.0),
                               ("ne", lambda a, b: a.ne(b), lambda a, b: (a != b) * 1.0)):
        PROVIDER_CASES[f"compare_{_name}_{_layout}"] = (_layout, (CX, CY), _op, _plain, 0)


def run_case(pkg, layout, inputs, op, seed=777, config=None, precisions=None):
    """One op of ``pkg`` ("port" or "curl_tpu") under ``layout`` and the keys
    of ``config`` over it, the inputs encrypted at ``precisions`` (the
    default's where None): (decoded, CommStats)."""
    ws = LAYOUTS[layout][2]
    config = dict(layout_config(layout), **(config or {}))
    precisions = precisions or [None] * len(inputs)
    if pkg == "port":
        with cfg.temp_override(config):
            ct.init(world_size=ws, seed=seed, device="cpu")
            enc = [ct.cryptensor(v, precision=p) for v, p in zip(inputs, precisions)]
            ct.reset_communication_stats()
            out = op(*enc)
            stats = ct.get_communication_stats()
        return out.get_plain_text(), stats
    with curl_tpu.cfg.temp_override(config):
        curl_tpu.init(world_size=ws, seed=seed)
        enc = [curl_tpu.cryptensor(v, precision=p) for v, p in zip(inputs, precisions)]
        with curl_tpu.no_grad():
            jcomm.reset_communication_stats()
            out = op(*enc)
            stats = jcomm.get_communication_stats()
        decoded = np.asarray(out.get_plain_text())
    return decoded, stats


# The tuple forms the form knobs force at tfp2 (name: (config, inputs,
# their precisions, op, plaintext, atol)): the LUT's one-hot-dot form and
# the embedding's rotated one-hot tuple, each the same rounds and bytes as
# the gather form it replaces, in both packages
_f = np.random.default_rng(13)
FORM_TABLE = _f.normal(size=(7, 3))
FORM_TOKENS = np.array([[1.0, 6.0, 0.0, 3.0]])
FORM_CASES = {
    "gelu_lut_one_hot": ({"mpc.lut_fastpath": False}, (GELU_X,), [None], lambda a: a.gelu(),
                         _gelu, LUT_TOL),
    "embed_one_hot_tuple": ({"mpc.fused_onehot": False}, (FORM_TOKENS, FORM_TABLE), [0, None],
                            lambda t, e: t.evaluate_embed(e),
                            lambda t, e: e[t.astype(int)], 2 ** -14),
}


def _golden():
    if not os.path.exists(GOLDEN):
        pytest.fail(f"{GOLDEN} is missing: run tests/torch_protocols_reference.py")
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def golden_stats(g, key):
    """A golden's CommStats: rounds, bytes and calls by collective."""
    rounds, nbytes = (int(v) for v in g[f"{key}/counts"])
    names = [str(n) for n in g[f"{key}/call_names"]]
    return {"rounds": rounds, "bytes": nbytes,
            "calls": dict(zip(names, (int(v) for v in g[f"{key}/call_counts"])))}


@pytest.fixture(scope="module")
def golden():
    return _golden()


# -- the sweep ------------------------------------------------------------------

SWEEP_RUNS = [(layout, name) for layout in SWEEP for name in OPS]


@pytest.fixture(scope="module")
def port_sweep():
    cache = {}

    def get(layout, name):
        if (layout, name) not in cache:
            inputs, op, *_ = OPS[name]
            cache[layout, name] = run_case("port", layout, inputs, op)
        return cache[layout, name]

    return get


@pytest.mark.parametrize("layout,name", SWEEP_RUNS, ids=[f"{l}-{n}" for l, n in SWEEP_RUNS])
def test_sweep_decodes_like_curl_tpu_and_plaintext(port_sweep, golden, layout, name):
    inputs, _, plain, atol, rtol = OPS[name]
    got, _ = port_sweep(layout, name)
    want = golden[f"sweep/{layout}/{name}/output"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    np.testing.assert_allclose(got, plain(*inputs), atol=atol, rtol=rtol)


@pytest.mark.parametrize("layout,name", SWEEP_RUNS, ids=[f"{l}-{n}" for l, n in SWEEP_RUNS])
def test_sweep_comm_stats_equal_curl_tpu(port_sweep, golden, layout, name):
    _, stats = port_sweep(layout, name)
    assert stats == golden_stats(golden, f"sweep/{layout}/{name}")


@pytest.mark.parametrize("case", sorted(PROVIDER_CASES))
def test_provider_cases_like_curl_tpu(golden, case):
    layout, inputs, op, plain, atol = PROVIDER_CASES[case]
    got, stats = run_case("port", layout, inputs, op, seed=1234)
    np.testing.assert_allclose(got, plain(*inputs), atol=atol)
    np.testing.assert_allclose(got, golden[f"provider/{case}/output"], atol=atol)
    assert stats == golden_stats(golden, f"provider/{case}")


@pytest.mark.parametrize("case", sorted(FORM_CASES))
def test_forced_tuple_forms_like_curl_tpu(golden, case):
    config, inputs, precisions, op, plain, atol = FORM_CASES[case]
    got, stats = run_case("port", "tfp2", inputs, op, config=config, precisions=precisions)
    np.testing.assert_allclose(got, plain(*inputs), atol=atol)
    np.testing.assert_allclose(got, golden[f"forms/{case}/output"], atol=atol)
    assert stats == golden_stats(golden, f"forms/{case}")


# -- the tiny GPT under the four layouts of phase 14 ------------------------------

def _gpt_state(g):
    sd = {k[len("gpt/sd/"):]: v for k, v in g.items() if k.startswith("gpt/sd/")}
    return sd, g["gpt/tokens"]


def port_gpt(layout, sd, tokens, skip=None, tamper=False, seed=5):
    """The port's tiny private forward under ``layout``, the embedding, the
    blocks, the final LayerNorm and the head's logits (curl_tpu's staged
    forward in tests/torch_protocols_reference.py): decoded (hidden,
    logits), CommStats, and the tuple requests it made (recorded
    alongside)."""
    from test_torch_gpt import TINY

    from curl_tpu_torch.models import GPT, load_numpy_state_dict
    from curl_tpu_torch.mpc import get_default_provider

    with cfg.temp_override(layout_config(layout)):
        ct.init(world_size=LAYOUTS[layout][2], seed=seed, device="cpu")
        pm = load_numpy_state_dict(GPT(full=True, **TINY), sd)
        if skip is not None:
            pm.blocks = type(pm.blocks)(*[b for i, b in enumerate(pm.blocks) if i != skip])
        pm.encrypt(src=0)
        px = ct.cryptensor(tokens.astype(np.float64), precision=0)
        provider = get_default_provider()
        if tamper:
            _tamper_port(provider)
        provider.requests = []
        ct.reset_communication_stats()
        ct.trace(True)
        try:
            h = pm.embed(px)
            for block in pm.blocks:
                h = block(h)
            h = pm.ln(h)
            logits = pm.fc(h)
        finally:
            ct.trace(False)
            provider.__dict__.pop("generate_additive_triple", None)
        stats = ct.get_communication_stats()
        requests = list(provider.requests)
        provider.requests = []
    return (h.get_plain_text(), logits.get_plain_text()), stats, requests


@pytest.fixture(scope="module")
def gpt_runs(golden):
    from test_torch_gpt import TINY, plain_forward

    sd, tokens = _gpt_state(golden)
    hidden, logits, _ = plain_forward(sd, tokens, TINY["num_heads"], TINY["num_blocks"])
    runs = {layout: port_gpt(layout, sd, tokens) for layout in MODEL_LAYOUTS + ("tfp2",)}
    return dict(sd=sd, tokens=tokens, runs=runs, plain=dict(hidden=hidden[-1], logits=logits))


def _within(got, plain, stage):
    from chip_smoke import hidden_stats
    from test_torch_gpt import TINY_BOUNDS

    stat, bound = TINY_BOUNDS[stage]
    return hidden_stats(got, plain)[stat], bound


@pytest.mark.parametrize("stage", ["hidden", "logits"])
@pytest.mark.parametrize("layout", MODEL_LAYOUTS)
def test_tiny_gpt_within_bounds_of_float64(gpt_runs, golden, layout, stage):
    """The port's final-LayerNorm hidden state and logits (and curl_tpu's,
    where it runs the layout) within tests/test_torch_gpt.py's bounds."""
    got = gpt_runs["runs"][layout][0][("hidden", "logits").index(stage)]
    err, bound = _within(got, gpt_runs["plain"][stage], stage)
    assert err <= bound
    if f"gpt/{layout}/raises" not in golden:
        key = f"gpt/{layout}/hidden/output" if stage == "hidden" else f"gpt/{layout}/logits"
        err, bound = _within(golden[key], gpt_runs["plain"][stage], stage)
        assert err <= bound


@pytest.mark.parametrize("layout", [l for l in MODEL_LAYOUTS if l != "active2"])
def test_tiny_gpt_comm_stats_equal_curl_tpu(gpt_runs, golden, layout):
    assert gpt_runs["runs"][layout][1] == golden_stats(golden, f"gpt/{layout}/hidden")


def test_curl_tpu_tiny_gpt_raises_under_active_security(golden):
    """curl_tpu's sacrifice check multiplies elementwise by a t of a's
    shape, which a matmul's c does not broadcast against (Queue C)."""
    assert "incompatible shapes" in str(golden["gpt/active2/raises"])


def test_tiny_gpt_active_security_costs_the_check_per_product(gpt_runs):
    """active2 = tfp2 (whose CommStats tests/test_torch_gpt.py holds to
    curl_tpu's) plus, for each Beaver product tfp2 asked a triple for, a
    second triple and the check: four reveals, of t (a's size for an
    elementwise product, one element otherwise), rho, sigma and the check."""
    _, passive, requests = gpt_runs["runs"]["tfp2"]
    _, active, _ = gpt_runs["runs"]["active2"]
    triples = [r.args for r in requests if r.func == "generate_additive_triple"]
    extra = 0
    for size0, size1, op in triples:
        a, b = np.zeros(size0), np.zeros(size1)
        c = a * b if op == "mul" else a @ b
        extra += (a.size if op == "mul" else 1) + a.size + b.size + c.size
    assert active["rounds"] == passive["rounds"] + 4 * len(triples)
    assert active["bytes"] == passive["bytes"] + 8 * extra


@pytest.mark.parametrize("layout", MODEL_LAYOUTS)
def test_tiny_gpt_planted_fault_exceeds_the_bounds(gpt_runs, layout):
    """The block left out (and, under active security, a tampered triple,
    which the check must poison) fails both bounds."""
    faults = [dict(skip=0)] + ([dict(tamper=True)] if layout == "active2" else [])
    for fault in faults:
        outs, _, _ = port_gpt(layout, gpt_runs["sd"], gpt_runs["tokens"], **fault)
        for stage, got in zip(("hidden", "logits"), outs):
            err, bound = _within(got, gpt_runs["plain"][stage], stage)
            assert err > bound, (fault, stage)


@pytest.mark.parametrize("layout", ["tfp3", "ttp2"])
def test_numpy_state_dict_decodes_alike_in_every_layout(golden, layout):
    """load_numpy_state_dict serves every layout: the same plaintext,
    encrypted at three parties or under TTP, decodes to the same weights."""
    from test_torch_gpt import TINY

    from curl_tpu_torch.models import GPT, load_numpy_state_dict

    sd, _ = _gpt_state(golden)
    with cfg.temp_override(layout_config(layout)):
        ct.init(world_size=LAYOUTS[layout][2], seed=9, device="cpu")
        pm = load_numpy_state_dict(GPT(full=True, **TINY), sd)
        pm.encrypt(src=0)
        for k, v in pm.state_dict().items():
            got = v.get_plain_text() if hasattr(v, "get_plain_text") else np.asarray(v)
            np.testing.assert_allclose(got, sd[k], atol=2 ** -16, err_msg=k)


# -- ppermute and the replicated product ----------------------------------------

def test_ppermute_counts_and_rolls_as_curl_tpus():
    shares = np.arange(12, dtype=np.uint64).reshape(3, 4) * np.uint64(7)
    curl_tpu.init(world_size=3, seed=1)
    jcomm.reset_communication_stats()
    want = np.asarray(jrun(lambda a: jcomm.ppermute(a, shift=1), 3, jax.random.PRNGKey(0), shares))
    jstats = jcomm.get_communication_stats()
    ct.init(world_size=3, seed=1, device="cpu")
    tcomm.reset_communication_stats()
    got = tcomm.ppermute(torch.from_numpy(shares.view(np.int64)), shift=1)
    assert np.array_equal(got.numpy().view(np.uint64), want)
    assert tcomm.get_communication_stats() == jstats == {
        "rounds": 1, "bytes": 32, "calls": {"ppermute": 1}}


def test_replicated_matmul_is_one_three_pair_product(monkeypatch):
    with cfg.temp_override({"mpc.protocol": "replicated"}):
        ct.init(world_size=3, seed=2, device="cpu")
        x, y = ct.cryptensor(np.ones((2, 5))), ct.cryptensor(np.ones((5, 3)))
        seen = []
        orig = tring.matmul_acc
        monkeypatch.setattr(tring, "matmul_acc", lambda pairs: seen.append(len(pairs)) or orig(pairs))
        z = replicated.matmul(x._tensor, y._tensor)
    assert seen == [3]
    g = torch.Generator().manual_seed(4)
    x1, x2 = (torch.randint(-2**63, 2**63 - 1, (3, 6, 70), dtype=torch.int64, generator=g)
              for _ in range(2))
    y1, y2 = (torch.randint(-2**63, 2**63 - 1, (3, 70, 5), dtype=torch.int64, generator=g)
              for _ in range(2))
    got = tring.matmul_acc([(x1, y1), (x1, y2), (x2, y1)])
    u = [t.numpy().view(np.uint64) for t in (x1, x2, y1, y2)]
    want = np.asarray(jring.matmul(u[0], u[2]) + jring.matmul(u[0], u[3]) + jring.matmul(u[1], u[2]))
    assert np.array_equal(got.numpy().view(np.uint64), want)
    assert z.share.shape == (3, 2, 3)


# -- active security ----------------------------------------------------------------

def _tamper_port(provider):
    """The provider's triples with c off by one in party 0's first element."""
    orig = provider.generate_additive_triple

    def tampered(*args, **kwargs):
        a, b, c = orig(*args, **kwargs)
        share = c.share.clone()
        share.view(share.shape[0], -1)[0, 0] += 1
        return a, b, c.with_share(share)

    provider.generate_additive_triple = tampered


def _tamper_curl_tpu(provider):
    import jax.numpy as jnp

    orig = provider.generate_additive_triple

    def tampered(*args, **kwargs):
        a, b, c = orig(*args, **kwargs)
        first = (jcomm.rank_signed() == 0).astype(jnp.uint64)
        share = c.share.reshape(-1).at[0].add(first).reshape(c.share.shape)
        return a, b, c.with_share(share)

    provider.generate_additive_triple = tampered


_a = np.random.default_rng(21)
AX, AY = _a.normal(size=(4,)), _a.normal(size=(4,))
ACTIVE = {"mpc.active_security": True}


def _active_mul(pkg, tamper):
    if pkg == "port":
        with cfg.temp_override(ACTIVE):
            ct.init(world_size=2, seed=12, device="cpu")
            provider = get_default_provider()
            x, y = ct.cryptensor(AX), ct.cryptensor(AY)
            if tamper:
                _tamper_port(provider)
            try:
                ct.reset_communication_stats()
                out = (x * y).get_plain_text()
                stats = ct.get_communication_stats()
            finally:
                provider.__dict__.pop("generate_additive_triple", None)
        return out, stats
    with curl_tpu.cfg.temp_override(ACTIVE):
        curl_tpu.init(world_size=2, seed=12)
        provider = curl_tpu.get_default_provider()
        x, y = curl_tpu.cryptensor(AX), curl_tpu.cryptensor(AY)
        if tamper:
            _tamper_curl_tpu(provider)
        try:
            with curl_tpu.no_grad():
                jcomm.reset_communication_stats()
                out = x * y
                stats = jcomm.get_communication_stats()
            out = np.asarray(out.get_plain_text())
        finally:
            provider.__dict__.pop("generate_additive_triple", None)
    return out, stats


@pytest.fixture(scope="module")
def active_runs():
    return {(pkg, tamper): _active_mul(pkg, tamper)
            for pkg in ("port", "curl_tpu") for tamper in (False, True)}


@pytest.mark.parametrize("pkg", ["port", "curl_tpu"])
def test_sacrifice_passes_honest_triples(active_runs, pkg):
    np.testing.assert_allclose(active_runs[pkg, False][0], AX * AY, atol=0.02)


@pytest.mark.parametrize("pkg", ["port", "curl_tpu"])
def test_sacrifice_poisons_a_tampered_triple(active_runs, pkg):
    assert np.abs(active_runs[pkg, True][0] - AX * AY).max() > 1e3


@pytest.mark.parametrize("tamper", [False, True])
def test_sacrifice_costs_curl_tpus_rounds_and_bytes(active_runs, tamper):
    assert active_runs["port", tamper][1] == active_runs["curl_tpu", tamper][1]
    assert active_runs["port", tamper][1]["rounds"] == 6  # 4 for the check


def test_sacrifice_of_a_matmul_poisons_only_a_tampered_triple():
    """The port checks a matmul at one revealed ring element t; curl_tpu's
    elementwise check raises for (3, 4) @ (4, 2) (ROADMAP Queue C)."""
    a, b = _a.normal(size=(3, 4)), _a.normal(size=(4, 2))
    with curl_tpu.cfg.temp_override(ACTIVE):
        curl_tpu.init(world_size=2, seed=12)
        with curl_tpu.no_grad(), pytest.raises(TypeError, match="incompatible shapes"):
            curl_tpu.cryptensor(a).matmul(curl_tpu.cryptensor(b))
    with cfg.temp_override(ACTIVE):
        ct.init(world_size=2, seed=12, device="cpu")
        x, y = ct.cryptensor(a), ct.cryptensor(b)
        ct.reset_communication_stats()
        np.testing.assert_allclose(x.matmul(y).get_plain_text(), a @ b, atol=0.05)
        # t (1 element), rho (12), sigma (8), the check (6), eps and delta, the rescale
        assert ct.get_communication_stats()["bytes"] == (1 + 12 + 8 + 6 + 12 + 8 + 6) * 8
        provider = get_default_provider()
        _tamper_port(provider)
        try:
            assert np.abs(x.matmul(y).get_plain_text() - a @ b).max() > 1e3
        finally:
            provider.__dict__.pop("generate_additive_triple")
