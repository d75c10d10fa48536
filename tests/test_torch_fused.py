"""The fused protocol passes of the port (kernels/fused_mul.py, max_step.py)
and the scan_reduction max, against curl_tpu and against the port's own
composable protocols.

* Bit-exact math: the same shares and the same stream of random draws
  (numpy, from a seed, in call order) go through curl_tpu's
  ``pallas_mul.fused_op_math``, ``pallas_max_step.ltz_bit_math`` and
  ``max_step_math`` (on u32 lo/hi planes, jitted) and the port's int64
  counterparts; the outputs must be equal bit for bit.
* MPC level, port only, on the CPU (the plain versions on Philox draws):
  decoded values against the plaintext and CommStats against the port's
  composable op with the knob off.
* Gates: below 1024 elements, at compare_bits 64 or with 3 parties the
  composable path runs (the plain versions are never called).
* scan_reduction against curl_tpu's on a (3, 300) input with narrow
  widths, so that the fold, the cascade and the butterfly all run.
* The tiny GPT of tests/test_torch_gpt.py under bench.py's kernel
  configuration, with the fused knobs on and off (the port alone).

As a script it prints the port's rounds by stage under bench.py's kernel
configuration on the CPU at a given width, vocabulary and depth:

    JAX_PLATFORMS=cpu python tests/test_torch_fused.py --width 24 --vocab 1000 --blocks 12
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import curl_tpu  # noqa: E402
from curl_tpu import comm as jcomm  # noqa: E402
from curl_tpu.ops import pallas_max_step as jms  # noqa: E402
from curl_tpu.ops import pallas_mul as jpm  # noqa: E402
from curl_tpu.ops import u64pair as up  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.kernels import fused_mul as fm  # noqa: E402
from curl_tpu_torch.kernels import max_step as ms  # noqa: E402

KNOBS = {"mpc.fused_mul": "cuda", "mpc.fused_trunc": "cuda",
         "mpc.fused_compare": "cuda", "mpc.fused_max_step": "cuda"}
# bench.py's kernel configuration: the scan_reduction max and the four knobs
BENCH = dict(KNOBS, **{"functions.max_method": "scan_reduction"})


def _u64(rng, *shape):
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def _i64(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _as_u64(t):
    return t.numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# bit-exact protocol math against curl_tpu
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _jax_fused_op(op, trunc, m, x0, x1, y0, y1, draws):
    it = iter(range(draws.shape[0]))

    def r64():
        return up.from_u64(draws[next(it)])

    def rk(bits):
        return up.from_u64(draws[next(it)] & jnp.uint64((1 << bits) - 1))

    pairs = [up.from_u64(v) for v in (x0, x1, y0, y1)]
    if op != "mul":
        pairs[2] = pairs[3] = None
    z0, z1 = jpm.fused_op_math(op, trunc, m, *pairs, r64, rk)
    return up.to_u64(*z0), up.to_u64(*z1)


def _port_fused_op(op, trunc, m, x0, x1, y0, y1, draws):
    it = iter(range(draws.shape[0]))

    def r64():
        return _i64(draws[next(it)])

    def rk(bits):
        return fm.low_bits(_i64(draws[next(it)]), bits)

    y = (_i64(y0), _i64(y1)) if op == "mul" else (None, None)
    z0, z1 = fm.fused_op_math(op, trunc, m, _i64(x0), _i64(x1), *y, r64, rk)
    return _as_u64(z0), _as_u64(z1)


# the op x trunc variants the bench configuration reaches: products with
# the EGK rescale and integer products without one, the crypten square,
# the LUT index truncation; and the crypten rescale of trunc_method.prod
FUSED_CASES = [("mul", "egk", 16), ("mul", "none", 0), ("square", "crypten", 16),
               ("trunc", "egk", 14), ("mul", "crypten", 16)]


@pytest.mark.parametrize("op,trunc,m", FUSED_CASES)
@pytest.mark.parametrize("n", [2049, 3000])
def test_fused_op_math_bit_exact_vs_curl_tpu(op, trunc, m, n):
    rng = np.random.default_rng(n + m)
    # shares of values in the EGK domain, plus ring-wide random shares
    v = rng.integers(-(1 << 40), 1 << 40, size=(2, n)).view(np.uint64)
    s = _u64(rng, 2, n)
    x0, x1, y0, y1 = s[0], v[0] - s[0], s[1], v[1] - s[1]
    draws = _u64(rng, len(fm.slot_spaces(op, trunc)), n)
    want = _jax_fused_op(op, trunc, m, x0, x1, y0, y1, draws)
    got = _port_fused_op(op, trunc, m, x0, x1, y0, y1, draws)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_sar_and_trunc_div_bit_exact_vs_curl_tpu():
    a = _u64(np.random.default_rng(1), 2048)
    a[:4] = [0, (1 << 64) - 1, 1 << 63, (1 << 32) - 1]
    pair = up.from_u64(jnp.asarray(a))
    for k in (1, 16, 31, 32, 33, 63):
        np.testing.assert_array_equal(_as_u64(fm.sar(_i64(a), k)),
                                      np.asarray(up.to_u64(*jpm.sar(pair, k))))
        np.testing.assert_array_equal(_as_u64(fm.trunc_div_pow2(_i64(a), k)),
                                      np.asarray(up.to_u64(*jpm.trunc_div_pow2(pair, k))))


def _word_draws(rng, slots, m):
    return _u64(rng, slots, m)


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_word_step(kind, c0, c1, r0, r1, draws):
    it = iter(range(draws.shape[0]))

    def rbits():
        return up.from_u64(draws[next(it)])

    def rbit():
        w = draws[next(it)]
        return jnp.stack([w & jnp.uint64(1), (w >> jnp.uint64(1)) & jnp.uint64(1)]).astype(
            jnp.uint32)

    planes = [up.from_u64(v) for v in (c0, c1, r0, r1)]
    if kind == "ltz":
        z0, z1 = jms.ltz_bit_math(planes[0], planes[1], rbits, rbit)
    else:
        z0, z1 = jms.max_step_math(*planes, rbits, rbit)
    return up.to_u64(*z0), up.to_u64(*z1)


def _port_word_step(kind, c0, c1, r0, r1, draws):
    it = iter(range(draws.shape[0]))

    def rbits():
        return _i64(draws[next(it)])

    def rbit():
        w = _i64(draws[next(it)])
        return torch.stack([w & 1, (w >> 1) & 1])

    if kind == "ltz":
        z0, z1 = ms.ltz_bit_math(_i64(c0), _i64(c1), rbits, rbit)
    else:
        z0, z1 = ms.max_step_math(_i64(c0), _i64(c1), _i64(r0), _i64(r1), rbits, rbit)
    return _as_u64(z0), _as_u64(z1)


@pytest.mark.parametrize("kind", ["ltz", "max_step"])
def test_word_math_bit_exact_vs_curl_tpu(kind):
    rng = np.random.default_rng(len(kind))
    m = 1029
    a = (rng.normal(size=(2, m)) * 2 ** 24).astype(np.int64).view(np.uint64)
    b = (rng.normal(size=(2, m)) * 2 ** 24).astype(np.int64).view(np.uint64)
    a[0, :3], b[0, :3] = 5, 5  # ties
    sa, sb = _u64(rng, 2, m), _u64(rng, 2, m)
    c0, c1, r0, r1 = sa, a - sa, sb, b - sb
    draws = _word_draws(rng, ms.DRAWS[kind], m)
    want = _jax_word_step(kind, c0, c1, r0, r1, draws)
    got = _port_word_step(kind, c0, c1, r0, r1, draws)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # and the result decodes to the plaintext answer
    dec = (got[0] + got[1]).view(np.int64)
    av, bv = a.view(np.int64), b.view(np.int64)
    want_dec = (av < 0) * 1 if kind == "ltz" else np.where(av >= bv, av, bv)
    np.testing.assert_array_equal(dec, want_dec)


def test_word_math_takes_every_draw():
    """DRAWS, the slot counts of the bit-exact test and of the kernels'
    bounds, are the protocols' own."""
    counts = {}
    for kind in ("ltz", "max_step"):
        n = [0]

        def rbits():
            n[0] += 1
            return torch.zeros(4, dtype=torch.int64)

        def rbit():
            n[0] += 1
            return torch.zeros(2, 4, dtype=torch.int64)

        z = torch.zeros(2, 4, dtype=torch.int64)
        if kind == "ltz":
            ms.ltz_bit_math(z, z, rbits, rbit)
        else:
            ms.max_step_math(z, z, z, z, rbits, rbit)
        counts[kind] = n[0]
    assert counts == ms.DRAWS


# ---------------------------------------------------------------------------
# MPC level, port only (CPU: the plain versions on Philox draws)
# ---------------------------------------------------------------------------

def _spy_plain(calls):
    """Count the plain versions' runs (fused_mul's by op+trunc; the chains'
    by name, each of whose steps also counts as its per-step plain) until
    the returned undo is called: on the CPU they stand where a CUDA tensor
    would launch the kernel."""
    saved = [(fm, "plain"), (ms, "plain_ltz"), (ms, "plain_max_step"),
             (fm, "plain_square_chain"), (ms, "plain_fold_chain"), (ms, "plain_butterfly_chain")]
    origs = [getattr(mod, name) for mod, name in saved]
    for (mod, name), orig in zip(saved, origs):
        def counted(*args, _orig=orig, _name=name, **kwargs):
            if _name == "plain":
                _name = f"{args[0]}+{args[1]}"
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*args, **kwargs)

        setattr(mod, name, counted)

    def undo():
        for (mod, name), orig in zip(saved, origs):
            setattr(mod, name, orig)

    return undo


@pytest.fixture
def spy():
    calls = {}
    undo = _spy_plain(calls)
    yield calls
    undo()


def _run(fn, inputs, knobs, ws=2, seed=7):
    ct.init(world_size=ws, seed=seed, device="cpu")
    enc = [ct.cryptensor(v) for v in inputs]
    with cfg.temp_override(knobs):
        ct.reset_communication_stats()
        out = fn(*enc)
        stats = ct.get_communication_stats()
    return out, stats


_r = np.random.default_rng(99)
A = _r.uniform(-8, 8, size=(37, 41))      # 1517 elements, odd
B = _r.uniform(-8, 8, size=(37, 41))
B_ROW = _r.uniform(-8, 8, size=(37, 1))   # a broadcast operand
B[0, :5] = A[0, :5]                        # ties

MPC_CASES = {
    # name: (inputs, op, plaintext, tolerance in units of 2^-16, plain hit)
    "mul_egk": ((A, B), lambda a, b: a * b, lambda a, b: a * b, 1, "mul+egk"),
    "mul_broadcast": ((A, B_ROW), lambda a, b: a * b, lambda a, b: a * b, 1, "mul+egk"),
    "square_crypten": ((A,), lambda a: a.square(), lambda a: a * a, 2, "square+crypten"),
    "trunc_egk": ((A * 64,), lambda a: a.egk_trunc_pr(62, 6), lambda a: a, 1, "trunc+egk"),
    "ltz": ((A,), lambda a: a._ltz(), lambda a: (a < 0) * 1.0, 0, "plain_ltz"),
    "ge": ((A, B), lambda a, b: a.ge(b), lambda a, b: (a >= b) * 1.0, 0, "plain_ltz"),
}


def _encoded(v):
    return np.trunc(np.asarray(v) * 65536).astype(np.int64)


@pytest.mark.parametrize("name", sorted(MPC_CASES))
def test_fused_mpc_decodes_and_counts_like_composable(name, spy):
    inputs, op, _, tol, hit = MPC_CASES[name]
    out, stats = _run(op, inputs, KNOBS)
    assert spy.get(hit, 0) == 1
    ref_out, ref_stats = _run(op, inputs, {})
    assert stats == ref_stats
    got = out.get_plain_text()
    if name.startswith(("ltz", "ge")):
        want = MPC_CASES[name][2](*[v for v in inputs])
        np.testing.assert_array_equal(got, want)
        return
    # exact integer reference on the encoded inputs: EGK errs by at most one
    # unit of 2^-16 (EGK+20 Fig. 10); the crypten rescale of a square by at
    # most two (each party truncates its own share, one unit each)
    enc = [_encoded(v) for v in inputs]
    if name == "trunc_egk":
        exact = enc[0] >> 6
        units = np.round(got * 65536).astype(np.int64)
    else:
        prod = enc[0] * (enc[1] if len(enc) > 1 else enc[0])
        exact = prod >> 16 if name != "square_crypten" else np.trunc(prod / 65536).astype(np.int64)
        units = np.round(got * 65536).astype(np.int64)
    assert np.abs(units - exact).max() <= tol


def test_fused_max_step_mpc_matches_composable_select():
    from curl_tpu_torch.functions.maximum import _tournament_select

    for fused in (True, False):
        ct.init(world_size=2, seed=3, device="cpu")
        c, r = ct.cryptensor(A), ct.cryptensor(B)
        ct.reset_communication_stats()
        out = _tournament_select(c, r, fused)
        stats = ct.get_communication_stats()
        np.testing.assert_array_equal(out.get_plain_text(), np.maximum(
            c.get_plain_text(), r.get_plain_text()))
        if fused:
            fused_stats = stats
    assert fused_stats == stats
    assert stats["calls"] == {"all_xor": 7, "all_sum": 1}


def test_fused_draws_are_fresh_per_call():
    """Two fused calls on the same input: same value, other shares."""
    ct.init(world_size=2, seed=1, device="cpu")
    a = ct.cryptensor(A)
    with cfg.temp_override(KNOBS):
        u, v = a._ltz(), a._ltz()
    assert torch.equal(u.share.sum(0), v.share.sum(0))
    assert not torch.equal(u.share, v.share)


@pytest.mark.parametrize("case", ["small", "compare_bits_64", "three_parties"])
def test_gates_keep_the_composable_path(case, spy):
    small = A[:4, :8]
    knobs = dict(KNOBS)
    inputs, ws = (A, B), 2
    if case == "small":
        inputs = (small, small)
    elif case == "compare_bits_64":
        knobs["mpc.compare_bits"] = 64
    else:
        ws = 3
    for op in (lambda a, b: a * b, lambda a, b: a.lt(b), lambda a, b: a.square()):
        _run(op, inputs, knobs, ws=ws)
    if case == "compare_bits_64":  # only the comparison is gated on the ring width
        assert spy == {"mul+egk": 1, "square+crypten": 1}
    else:
        assert spy == {}


# ---------------------------------------------------------------------------
# scan_reduction against curl_tpu
# ---------------------------------------------------------------------------

SCAN_X = np.random.default_rng(5).normal(size=(3, 300)) * 4
SCAN_NARROW = {"functions.max_method": "scan_reduction", "functions.scan_fixed_width": 64,
               "functions.scan_cascade_min": 8, "functions.scan_cascade_factor": 2}


@pytest.fixture(scope="module")
def scan_runs():
    curl_tpu.init(world_size=2, seed=1234)
    jx = curl_tpu.cryptensor(SCAN_X)
    with curl_tpu.cfg.temp_override(SCAN_NARROW), curl_tpu.no_grad():
        jcomm.reset_communication_stats()
        jout = jx.max_value(-1)
        jstats = jcomm.get_communication_stats()
    runs = {"curl_tpu": (jout.get_plain_text(), jstats)}
    for label, knobs in (("port", SCAN_NARROW), ("port_fused", dict(SCAN_NARROW, **KNOBS))):
        out, stats = _run(lambda a: a.max_value(-1), (SCAN_X,), knobs, seed=1234)
        runs[label] = (out.get_plain_text(), stats)
    return runs


@pytest.mark.parametrize("pkg", ["curl_tpu", "port", "port_fused"])
def test_scan_reduction_max_matches_plaintext(scan_runs, pkg):
    got = scan_runs[pkg][0]
    np.testing.assert_allclose(got, SCAN_X.max(-1), atol=2 ** -15, rtol=0)


def test_scan_reduction_fused_comm_stats_equal_composable(scan_runs):
    assert scan_runs["port_fused"][1] == scan_runs["port"][1]


def _select_stats(width):
    """CommStats of one composable tournament step on a (3, width) carry."""
    from curl_tpu_torch.functions.maximum import _tournament_select

    ct.init(world_size=2, seed=0, device="cpu")
    c = ct.cryptensor(np.zeros((3, width)))
    ct.reset_communication_stats()
    _tournament_select(c, c, False)
    return ct.get_communication_stats()


def test_scan_reduction_comm_stats_vs_curl_tpu(scan_runs):
    """curl_tpu counts CommStats at trace time, so each lax.scan body counts
    once whatever its trip count; the port counts every step. On (3, 300)
    the stages are the fold 512 -> 64 (7 steps), the cascade 64 -> 32 ->
    16 -> 8 (1 step each) and the butterfly over 8 lanes (3 steps):
    curl_tpu's stats are one step of each stage, the port's every step."""
    steps = [(64, 7), (32, 1), (16, 1), (8, 1), (8, 3)]
    per = [(_select_stats(w), k) for w, k in steps]

    def total(weighted):
        out = {"rounds": 0, "bytes": 0, "calls": {}}
        for st, k in per:
            k = k if weighted else 1
            out["rounds"] += k * st["rounds"]
            out["bytes"] += k * st["bytes"]
            for name, c in st["calls"].items():
                out["calls"][name] = out["calls"].get(name, 0) + k * c
        return out

    assert scan_runs["curl_tpu"][1] == total(weighted=False)
    assert scan_runs["port"][1] == total(weighted=True)
    assert scan_runs["port"][1]["rounds"] == 13 * 8


def test_curl_tpu_fused_mul_counts_a_broadcast_product_at_full_size(monkeypatch):
    """curl_tpu's fused_mul registers 2 n * 8 bytes for eps and delta
    (pallas_mul.py:350) where its composable product opens a broadcast
    operand at its own size; the port's fused pass opens each operand at its
    own size, as the composable path does."""
    x_v, y_v = np.ones((64, 32)), np.ones((64, 1))
    curl_tpu.init(world_size=2, seed=1)
    jx, jy = curl_tpu.cryptensor(x_v), curl_tpu.cryptensor(y_v)
    jcomm.reset_communication_stats()
    jx * jy
    composable = jcomm.get_communication_stats()["bytes"]
    # the kernel needs a TPU: stand in for it and keep the registration
    monkeypatch.setattr(jpm, "_get_fused", lambda *a: (lambda xs, ys, seed: xs))
    jcomm.reset_communication_stats()
    curl_tpu._eager_run(lambda a, b: jpm.fused_mul_mpc(a._tensor, b._tensor, "egk", 16), jx, jy)
    fused = jcomm.get_communication_stats()["bytes"]
    assert (composable, fused) == ((2048 + 64) * 8 + 2048 * 8, (2 * 2048 + 2048) * 8)
    _, port_fused = _run(lambda a, b: a * b, (x_v, y_v), KNOBS)
    assert port_fused["bytes"] == composable


def test_pad_puts_the_public_value_on_party_zero():
    ct.init(world_size=2, seed=0, device="cpu")
    x = ct.cryptensor(np.ones((2, 3)))
    p = x.pad((0, 2), value=-3.5)
    np.testing.assert_array_equal(p.get_plain_text(), np.pad(np.ones((2, 3)), ((0, 0), (0, 2)),
                                                             constant_values=-3.5))
    assert torch.equal(p.share[1, :, 3:], torch.zeros(2, 2, dtype=torch.int64))


# ---------------------------------------------------------------------------
# the slice as a whole: the tiny GPT under bench.py's kernel configuration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_bench():
    from chip_smoke import random_gpt2_state
    from test_torch_gpt import BATCH, TINY, _port_forward, plain_forward

    sd = random_gpt2_state(np.random.default_rng(0), TINY["seq_len"], TINY["num_blocks"],
                           d=TINY["embed_dim"], vocab=TINY["vocab_size"])
    tokens = np.random.default_rng(3).integers(0, TINY["vocab_size"], size=(BATCH, TINY["seq_len"]))
    hidden, logits, _ = plain_forward(sd, tokens, TINY["num_heads"], TINY["num_blocks"])
    runs = {"plaintext": dict(hidden=hidden[-1], logits=logits)}
    calls = {}
    for label, knobs, skip in (("on", BENCH, None), ("off", SCAN_BENCH_OFF, None),
                               ("fault", BENCH, 0)):
        spied = _spy_plain(calls.setdefault(label, {}))
        try:
            with cfg.temp_override(knobs):
                (h, lg, _), stats, _ = _port_forward(sd, tokens, skip=skip)
        finally:
            spied()
        runs[label] = dict(hidden=h, logits=lg, stats=stats)
    runs["calls"] = calls
    return runs


SCAN_BENCH_OFF = {"functions.max_method": "scan_reduction"}




def test_tiny_gpt_bench_config_engages_every_fused_pass(tiny_bench):
    on, off = tiny_bench["calls"]["on"], tiny_bench["calls"]["off"]
    assert off == {}
    # the tiny vocabulary (32) leaves no chunk to fold: the fold chain is
    # held by scan_runs and tests/test_torch_fused_chain.py
    for key in ("mul+egk", "square+crypten", "trunc+egk", "plain_ltz", "plain_max_step",
                "plain_square_chain", "plain_butterfly_chain"):
        assert on.get(key, 0) > 0, on


@pytest.mark.parametrize("key", ["rounds", "bytes", "calls"])
def test_tiny_gpt_bench_config_comm_stats_equal_knobs_off(tiny_bench, key):
    assert tiny_bench["on"]["stats"][key] == tiny_bench["off"]["stats"][key]


@pytest.mark.parametrize("run", ["on", "off"])
@pytest.mark.parametrize("stage", ["hidden", "logits"])
def test_tiny_gpt_bench_config_matches_plaintext(tiny_bench, run, stage):
    from chip_smoke import hidden_stats
    from test_torch_gpt import TINY_BOUNDS

    stat, bound = TINY_BOUNDS[stage]
    assert hidden_stats(tiny_bench[run][stage], tiny_bench["plaintext"][stage])[stat] <= bound


@pytest.mark.parametrize("stage", ["hidden", "logits"])
def test_tiny_gpt_bench_config_planted_fault_fails(tiny_bench, stage):
    from chip_smoke import hidden_stats
    from test_torch_gpt import TINY_BOUNDS

    stat, bound = TINY_BOUNDS[stage]
    assert hidden_stats(tiny_bench["fault"][stage], tiny_bench["plaintext"][stage])[stat] > bound


def rounds_by_stage(width, vocab, blocks, seq=64):
    """Rounds of the port's private forward under bench.py's kernel
    configuration on the CPU, by stage (embedding, blocks, final LayerNorm,
    LM head, vocab softmax), for seeded random weights of the given
    geometry (12 heads)."""
    from chip_smoke import BENCH_CONFIG, random_gpt2_state
    from curl_tpu_torch.models import GPT, load_numpy_state_dict

    ct.init(world_size=2, seed=0, device="cpu")
    sd = random_gpt2_state(np.random.default_rng(0), seq, blocks, d=width, vocab=vocab)
    model = load_numpy_state_dict(GPT(width, 12, blocks, vocab, seq), sd)
    model.encrypt(src=0)
    tokens = np.random.default_rng(1).integers(0, vocab, (1, seq)).astype(np.float64)
    x = ct.cryptensor(tokens, precision=0)
    stages = {}
    with cfg.temp_override(BENCH_CONFIG):
        ct.reset_communication_stats()
        for name, fn in (("embedding", model.embed), ("blocks", model.blocks), ("ln", model.ln),
                         ("lm_head", model.fc), ("softmax", model.softmax)):
            before = ct.get_communication_stats()["rounds"]
            x = fn(x)
            stages[name] = ct.get_communication_stats()["rounds"] - before
    return stages


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Rounds by stage under bench.py's kernel "
                                             "configuration, on the CPU")
    ap.add_argument("--width", type=int, default=24)
    ap.add_argument("--vocab", type=int, default=1000)
    ap.add_argument("--blocks", type=int, default=1)
    args = ap.parse_args()
    st = rounds_by_stage(args.width, args.vocab, args.blocks)
    print(f"width {args.width}, vocab {args.vocab}, {args.blocks} blocks: {st}, "
          f"total {sum(st.values())}")


# ---------------------------------------------------------------------------
# the fused key read from the session key table
# ---------------------------------------------------------------------------

def _key_cases(device, kernel=False):
    """(name, call(key)) of every fused kernel entry, the plain versions or
    (``kernel``) the launches: each call takes the key as a key-table
    slot."""
    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.randint(-(2 ** 40), 2 ** 40, s, generator=g).to(device)  # noqa: E731
    x, y, chunked = r(2, 9, 130), r(2, 9, 1), r(2, 3, 4, 64)
    mul, chain, ltz, step, fold, butterfly = (
        (fm.launch, fm.launch_square_chain, ms.launch_ltz, ms.launch_max_step,
         ms.launch_fold_chain, ms.launch_butterfly_chain) if kernel else
        (fm.plain, fm.plain_square_chain, ms.plain_ltz, ms.plain_max_step, ms.plain_fold_chain,
         ms.plain_butterfly_chain))
    return [
        ("mul+egk", lambda k: mul("mul", "egk", 16, x, y, k, 7)),
        ("square+crypten", lambda k: mul("square", "crypten", 16, x, None, k, 7)),
        ("trunc+egk", lambda k: mul("trunc", "egk", 12, x, None, k, 7)),
        ("square chain", lambda k: chain("crypten", 16, x, 8, k, 7)),
        ("ltz", lambda k: ltz(x, k, 7)),
        ("max_step", lambda k: step(x, y, k, 7)),
        ("fold", lambda k: fold(chunked, k, 7)),
        ("butterfly", lambda k: butterfly(chunked.reshape(2, 12, 64), 6, k, 7)),
    ]


@pytest.mark.parametrize("case", range(8))
def test_fused_plain_reads_the_slot_as_the_literal_key(case):
    from curl_tpu_torch.kernels.keys import KeyTable, hold

    name, call = _key_cases("cpu")[case]
    table = KeyTable(4)
    key = 0x0123_4567_89AB_CDEF
    table.write([key ^ 5, key], 1)
    literal, moved = hold((key,), (key ^ 9,))  # the same keys in slots of their own
    want = call(literal)
    assert torch.equal(call(table.ref(2)), want), name
    assert not torch.equal(call(table.ref(1)), want), name
    table.write([key ^ 9], 2)  # the slot is read at the call
    assert torch.equal(call(table.ref(2)), call(moved)), name
    assert not torch.equal(call(table.ref(2)), want), name


def test_fused_mpc_entries_name_the_session_fused_slot(monkeypatch):
    from curl_tpu_torch import random as trng
    from curl_tpu_torch.kernels.keys import KeyRef

    ct.init(world_size=2, seed=31, device="cpu")
    seen = []
    for mod, name in ((fm, "fused_mul"), (fm, "square_chain"), (ms, "ltz"), (ms, "max_step"),
                      (ms, "fold_chain"), (ms, "butterfly_chain")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name: (seen.append((_n, a[-2])),
                                                                     _o(*a))[1])
    x = ct.cryptensor(np.linspace(-2, 2, 2048).reshape(32, 64))
    with cfg.temp_override(BENCH):
        (x * x).exp()
        x.max_value(-1)
        x.gelu()
    names = {n for n, _ in seen}
    assert {"fused_mul", "square_chain", "ltz"} <= names and names & {"fold_chain",
                                                                       "butterfly_chain"}
    for name, key in seen:
        assert isinstance(key, KeyRef) and key.table is trng.TABLE, name
        assert key.slot == trng.SLOTS["fused"] and key.values() == tuple(
            trng.current_keys()["fused"]), name


@pytest.mark.cuda
def test_fused_kernels_read_the_slot_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from curl_tpu_torch.kernels.keys import KeyTable, hold

    table = KeyTable(4)
    key = 0x0123_4567_89AB_CDEF
    table.write([key ^ 5, key], 1)
    literal, moved = hold((key,), (key ^ 9,))
    for (name, launch), (_, plain) in zip(_key_cases("cuda", kernel=True), _key_cases("cuda")):
        want = plain(literal)
        assert torch.equal(launch(literal), want), name
        assert torch.equal(launch(table.ref(2)), want), name
        table.write([key ^ 9], 2)  # in stream order: the next launch reads it
        got = launch(table.ref(2))
        assert torch.equal(got, plain(moved)) and not torch.equal(got, want), name
        table.write([key], 2)
