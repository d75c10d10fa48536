"""The lazy scope (``curl_tpu_torch/lazy.py``) against curl_tpu's
``lazy()`` and against the same ops run eagerly.

The seven cases of tests/test_lazy.py run in the port with the same inputs
(numpy seed 7, session seed 9) and tolerances. Each scope's decoded outputs
and its rounds and bytes are held to curl_tpu's readings in
``tests/golden/torch_lazy_reference.npz``, which

    JAX_PLATFORMS=cpu python3 tests/torch_lazy_reference.py

writes from curl_tpu's own ``lazy()`` (tests/test_lazy.py alone runs for
minutes on a CPU, so curl_tpu is not run here). Then the port's own
guarantees: one flush a scope, one program a repeated scope, fresh shares
each flush, CommStats equal to the eager ops', a fallback counted and
right, a new capture after a config change, public tensors read anew, a
scope served from the host tuple cache, the tiny GPT and a training step
in a scope. No JAX here: on a card the cuda-marked case runs without the
conftest (``python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_lazy.py``).
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch.lazy import call as lazy_call, flush_seed  # noqa: E402
from curl_tpu_torch import random as trng  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "golden", "torch_lazy_reference.npz")
SESSION_SEED = 9
DATA_SEED = 7


# -- the seven cases of tests/test_lazy.py, for either package ----------------
# Each takes the package (curl_tpu or curl_tpu_torch) and the numpy
# generator, runs its scope and returns (decoded outputs, the scope's
# CommStats, what the port's checks read).

def _scope_stats(pkg):
    return pkg.comm.get_communication_stats()


def case_exact_linear_ops(pkg, rng):
    x = rng.normal(size=(3, 4))
    xe = pkg.cryptensor(x)
    pkg.comm.reset_communication_stats()
    with pkg.lazy() as tape:
        a = xe + 1.5
        b = a - 0.25
        c = b * 2.0  # public mul: exact
        d = c.sum(axis=1)
    stats = _scope_stats(pkg)
    return dict(d=d.get_plain_text(), a=a.get_plain_text()), stats, dict(
        x=x, tape=tape, filled=[t for t in (a, b, c)])


def case_nonlinear(pkg, rng):
    x = rng.normal(size=(4, 8))
    w = rng.normal(size=(8, 8))
    xe, we = pkg.cryptensor(x), pkg.cryptensor(w)
    pkg.comm.reset_communication_stats()
    with pkg.lazy() as tape:
        p = xe.matmul(we).gelu().softmax(-1)
    stats = _scope_stats(pkg)
    return dict(p=p.get_plain_text()), stats, dict(x=x, w=w, tape=tape)


def case_pending_metadata(pkg, rng):
    x = rng.normal(size=(2, 5))
    xe = pkg.cryptensor(x)
    y_plain = rng.normal(size=(5, 3))
    pkg.comm.reset_communication_stats()
    with pkg.lazy() as tape:
        y = xe.matmul(pkg.cryptensor(y_plain))
        meta = dict(shape=tuple(y.shape), ndim=y.ndim, size1=y.size(1), repr=repr(y),
                    nodes=len(tape.nodes))
    stats = _scope_stats(pkg)
    return dict(y=y.get_plain_text()), stats, dict(x=x, y_plain=y_plain, tape=tape, meta=meta,
                                                   y=y)


def case_midscope_flush(pkg, rng):
    x = rng.normal(size=(4,))
    xe = pkg.cryptensor(x)
    pkg.comm.reset_communication_stats()
    with pkg.lazy() as tape:
        a = xe + 1.0
        mid = a.get_plain_text()
        b = a * 3.0  # recording continues after the mid-scope flush
    stats = _scope_stats(pkg)
    return dict(mid=mid, b=b.get_plain_text()), stats, dict(x=x, tape=tape)


def case_comparisons_and_max(pkg, rng):
    x = rng.normal(size=(3, 9)) * 10
    xe = pkg.cryptensor(x)
    pkg.comm.reset_communication_stats()
    with pkg.lazy() as tape:
        m = xe.max(-1)[0]
        s = xe.relu()
    stats = _scope_stats(pkg)
    return dict(m=m.get_plain_text(), s=s.get_plain_text()), stats, dict(x=x, tape=tape)


def case_nested_scopes(pkg, rng):
    x = rng.normal(size=(4,))
    xe = pkg.cryptensor(x)
    pkg.comm.reset_communication_stats()
    with pkg.lazy() as outer:
        a = xe + 1.0
        with pkg.lazy() as inner_tape:
            inner = xe * 2.0
        inner_done = _is_filled(inner)
        b = a + inner
    stats = _scope_stats(pkg)
    return dict(b=b.get_plain_text()), stats, dict(x=x, tape=outer, inner_tape=inner_tape,
                                                   inner_done=inner_done)


def case_single_program(pkg, rng):
    x = rng.normal(size=(3,))
    xe = pkg.cryptensor(x)
    pkg.comm.reset_communication_stats()
    with pkg.lazy() as tape:
        y = ((xe + 1.0) * 2.0 - 0.5).square()
    stats = _scope_stats(pkg)
    return dict(y=y.get_plain_text()), stats, dict(x=x, tape=tape)


def _is_filled(t):
    """Whether a scope's output holds its shares (either package)."""
    return getattr(t, "_mpc", None) is not None or getattr(t, "_inner", None) is not None


CASES = {
    "exact_linear_ops": case_exact_linear_ops,
    "nonlinear": case_nonlinear,
    "pending_metadata": case_pending_metadata,
    "midscope_flush": case_midscope_flush,
    "comparisons_and_max": case_comparisons_and_max,
    "nested_scopes": case_nested_scopes,
    "single_program": case_single_program,
}

# decoded outputs: the tolerance of tests/test_lazy.py against the
# plaintext, and against curl_tpu's decoded output
TOLERANCES = {"exact_linear_ops": 2e-4, "nonlinear": 0.15, "pending_metadata": 2e-4,
              "midscope_flush": 6e-4, "comparisons_and_max": 2e-4, "nested_scopes": 4e-4,
              "single_program": 1e-3}


class Eager:
    """A package whose ``lazy()`` records nothing: the case's ops run
    eagerly (its tape an empty stand-in)."""

    def __init__(self, pkg):
        self.pkg = pkg

    def __getattr__(self, name):
        return getattr(self.pkg, name)

    @staticmethod
    def lazy():
        import contextlib
        import types

        return contextlib.nullcontext(types.SimpleNamespace(nodes=[]))


def run_case(pkg, name):
    """One case in ``pkg`` from a fresh session (seed 9) and numpy seed 7."""
    pkg.init(world_size=2, seed=SESSION_SEED, **({"device": "cpu"} if pkg is ct else {}))
    return CASES[name](pkg, np.random.default_rng(DATA_SEED))


def _plain(name, aux):
    """The float64 values of a case's outputs (tests/test_lazy.py's)."""
    x = aux["x"]
    if name == "exact_linear_ops":
        return dict(d=((x + 1.25) * 2).sum(1), a=x + 1.5)
    if name == "nonlinear":
        z = x @ aux["w"]
        g = 0.5 * z * (1 + np.tanh(np.sqrt(2 / np.pi) * (z + 0.044715 * z ** 3)))
        sm = np.exp(g - g.max(-1, keepdims=True))
        return dict(p=sm / sm.sum(-1, keepdims=True))
    if name == "pending_metadata":
        return dict(y=x @ aux["y_plain"])
    if name == "midscope_flush":
        return dict(mid=x + 1.0, b=(x + 1.0) * 3.0)
    if name == "comparisons_and_max":
        return dict(m=x.max(-1), s=np.maximum(x, 0))
    if name == "nested_scopes":
        return dict(b=x * 3.0 + 1.0)
    return dict(y=((x + 1) * 2 - 0.5) ** 2)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("name", list(CASES))
def test_case_as_curl_tpu(golden, name):
    """Each of tests/test_lazy.py's scopes: its outputs within the test's
    tolerance of the plaintext and of curl_tpu's decoded outputs, its rounds
    and bytes those of curl_tpu's ops run eagerly (see the next test), one
    flush a scope (two where the scope reads a result inside) and no
    fallback."""
    outs, stats, aux = run_case(ct, name)
    tol = TOLERANCES[name]
    for key, want in _plain(name, aux).items():
        np.testing.assert_allclose(outs[key], want, atol=tol, err_msg=key)
        np.testing.assert_allclose(outs[key], golden[f"{name}/{key}"], atol=tol, err_msg=key)
    assert [stats["rounds"], stats["bytes"]] == golden[f"{name}/eager_counts"].tolist()
    tape = aux["tape"]
    assert tape.flushes == (2 if name == "midscope_flush" else 1)
    assert tape.fallbacks == 0


@pytest.mark.parametrize("name", list(CASES))
def test_curl_tpu_scope_counts_its_ops_twice(golden, name):
    """A fault of the reference, not reproduced: curl_tpu's ``lazy()``
    counts each recorded op's CommStats when ``jax.eval_shape`` traces it
    (curl_tpu/lazy.py:105-108) and again when the flush traces the program,
    so a scope reads twice its ops' eager rounds and bytes. The port's
    scope counts them once (the test above)."""
    assert golden[f"{name}/counts"].tolist() == (2 * golden[f"{name}/eager_counts"]).tolist()


def test_exact_linear_intermediates_filled_by_the_same_flush():
    _, _, aux = run_case(ct, "exact_linear_ops")
    assert all(t._inner is not None for t in aux["filled"])
    assert aux["tape"].flushes == 1


def test_pending_metadata_without_flush():
    _, _, aux = run_case(ct, "pending_metadata")
    meta = aux["meta"]
    assert meta["shape"] == (2, 3) and meta["ndim"] == 2 and meta["size1"] == 3
    assert "pending" in meta["repr"]
    assert meta["nodes"] >= 1  # nothing flushed by metadata queries
    assert aux["y"]._inner is not None  # scope exit flushed


def test_nested_scope_flushes_its_own_tape():
    _, _, aux = run_case(ct, "nested_scopes")
    assert aux["inner_done"]
    assert aux["inner_tape"].flushes == 1 and aux["tape"].flushes == 1


def test_cross_tape_dependency_flushes_the_other_tape_first():
    ct.init(world_size=2, seed=SESSION_SEED, device="cpu")
    xe = ct.cryptensor(np.arange(4.0))
    with ct.lazy() as outer:
        a = xe + 1.0
        with ct.lazy() as inner:
            b = a * 2.0  # reads the outer tape's pending a
            assert outer.flushes == 1 and a._inner is not None
        assert inner.flushes == 1
    np.testing.assert_allclose(b.get_plain_text(), (np.arange(4.0) + 1) * 2, atol=4e-4)


# -- the port's own guarantees ------------------------------------------------

def _mlp_scope(xe, we, bias):
    with ct.lazy() as tape:
        y = xe.matmul(we).add(bias).relu()
    return y, tape


def _mlp_inputs():
    ct.init(world_size=2, seed=SESSION_SEED, device="cpu")
    rng = np.random.default_rng(DATA_SEED)
    x, w = rng.normal(size=(4, 6)), rng.normal(size=(6, 3))
    bias = torch.from_numpy(rng.normal(size=3))
    return x, w, bias, ct.cryptensor(x), ct.cryptensor(w)


def _mlp_plain(x, w, bias):
    return np.maximum(x @ w + bias.numpy(), 0)


def test_repeated_scope_reuses_one_program_with_fresh_shares():
    x, w, bias, xe, we = _mlp_inputs()
    y1, t1 = _mlp_scope(xe, we, bias)
    y2, t2 = _mlp_scope(xe, we, bias)
    assert t1.flushes == t2.flushes == 1
    assert t2.program is t1.program and t1.program.captures == 1
    assert t1.seed != t2.seed
    assert not torch.equal(y1.share, y2.share)  # fresh randomness each flush
    for y in (y1, y2):
        np.testing.assert_allclose(y.get_plain_text(), _mlp_plain(x, w, bias), atol=2e-3)


def test_flush_seeds_never_repeat_nor_equal_the_session_seed():
    ct.init(world_size=2, seed=SESSION_SEED, device="cpu")
    seeds = [flush_seed() for _ in range(1000)]
    assert len(set(seeds)) == len(seeds) and SESSION_SEED not in seeds
    ct.init(world_size=2, seed=SESSION_SEED, device="cpu")
    assert flush_seed() == seeds[0]  # init restarts them


def test_scope_comm_stats_equal_the_eager_ops():
    x, w, bias, xe, we = _mlp_inputs()
    ct.reset_communication_stats()
    eager = xe.matmul(we).add(bias).relu()
    want = ct.get_communication_stats()
    for _ in range(2):  # the capture's flush and a replay count alike
        ct.reset_communication_stats()
        y, _ = _mlp_scope(xe, we, bias)
        assert ct.get_communication_stats() == want
    np.testing.assert_allclose(y.get_plain_text(), eager.get_plain_text(), atol=2e-3)


def _host_scaled(t):
    """An op that reads a value on the host: no abstract evaluation."""
    return t * float(np.abs(t.get_plain_text()).max())


def test_fallback_is_counted_and_right():
    x, w, bias, xe, we = _mlp_inputs()
    with ct.lazy() as tape:
        y = xe.matmul(we)
        z = lazy_call(_host_scaled, y)
        out = z + 1.0
    assert tape.fallbacks == 1 and tape.flushes == 2  # the fallback's flush, then the exit's
    prod = x @ w
    np.testing.assert_allclose(out.get_plain_text(), prod * np.abs(prod).max() + 1.0,
                               rtol=2e-3, atol=0.05)


def _gelu64(x):
    from math import erf

    return 0.5 * x * (1 + np.vectorize(erf)(x / np.sqrt(2)))


def _counted(fn):
    """(fn's result, the CommStats it counted)."""
    ct.reset_communication_stats()
    out = fn()
    return out, ct.get_communication_stats()


ERF_GELU = {"functions.gelu_method": "erf"}


def test_config_change_captures_anew():
    """A scope under another config is another program, and counts what
    the eager op counts under that config (its rounds differ)."""
    ct.init(world_size=2, seed=SESSION_SEED, device="cpu")
    x = np.linspace(-3, 3, 24).reshape(4, 6)
    xe = ct.cryptensor(x)
    _, default_stats = _counted(lambda: xe.gelu())
    with cfg.temp_override(ERF_GELU):
        _, erf_stats = _counted(lambda: xe.gelu())
    assert erf_stats["rounds"] != default_stats["rounds"]

    def scope():
        with ct.lazy() as tape:
            g = xe.gelu()
        return g, tape

    (g1, t1), s1 = _counted(scope)
    with cfg.temp_override(ERF_GELU):
        (g2, t2), s2 = _counted(scope)
    (g3, t3), s3 = _counted(scope)
    assert t2.program is not t1.program and t3.program is t1.program
    assert s1 == s3 == default_stats and s2 == erf_stats
    for g in (g1, g2, g3):
        np.testing.assert_allclose(g.get_plain_text(), _gelu64(x), atol=0.05)


def test_config_changed_inside_a_scope_holds_for_its_ops():
    """Each node runs under the config it was recorded under."""
    ct.init(world_size=2, seed=SESSION_SEED, device="cpu")
    x = np.linspace(-3, 3, 8)
    xe = ct.cryptensor(x)
    _, default_stats = _counted(lambda: xe.gelu())
    with cfg.temp_override(ERF_GELU):
        _, erf_stats = _counted(lambda: xe.gelu())

    def scope():
        with ct.lazy():
            with cfg.temp_override(ERF_GELU):
                g_erf = xe.gelu()
            g_default = xe.gelu()
        return g_erf, g_default

    (g_erf, g_default), stats = _counted(scope)
    assert stats["rounds"] == erf_stats["rounds"] + default_stats["rounds"]
    assert stats["bytes"] == erf_stats["bytes"] + default_stats["bytes"]
    for g in (g_erf, g_default):
        np.testing.assert_allclose(g.get_plain_text(), _gelu64(x), atol=0.05)


def test_public_tensor_changed_between_scopes_is_read_anew():
    x, w, bias, xe, we = _mlp_inputs()
    y1, t1 = _mlp_scope(xe, we, bias)
    bias.add_(5.0)  # in place: the program reads it anew
    y2, t2 = _mlp_scope(xe, we, bias)
    other = bias - 7.0  # another tensor at another address
    y3, t3 = _mlp_scope(xe, we, other)
    assert t2.program is t1.program and t3.program is t1.program
    np.testing.assert_allclose(y2.get_plain_text(), _mlp_plain(x, w, bias), atol=2e-3)
    np.testing.assert_allclose(y3.get_plain_text(), _mlp_plain(x, w, other), atol=2e-3)


@pytest.fixture()
def provider():
    from curl_tpu_torch.mpc import get_default_provider

    yield get_default_provider()
    get_default_provider().attach_cache(None)
    get_default_provider().trace(False)
    get_default_provider().requests = []


def test_scope_under_fill_cache_consumes_the_eager_ops_entries(provider):
    x, w, bias, xe, we = _mlp_inputs()
    provider.requests = []
    ct.trace(True)
    xe.matmul(we).add(bias).relu()
    ct.trace(False)
    cache = ct.fill_cache()
    n = len(cache.entries)
    eager = xe.matmul(we).add(bias).relu()  # served: pops every entry
    assert cache.cursor == n
    cache.reset()
    y, tape = _mlp_scope(xe, we, bias)
    assert cache.cursor == n and tape.flushes == 1 and tape.program is None
    np.testing.assert_allclose(y.get_plain_text(), eager.get_plain_text(), atol=2e-3)
    with pytest.raises(RuntimeError, match="exhausted"):
        _mlp_scope(xe, we, bias)


def test_scope_while_tracing_records_the_eager_ops_requests(provider):
    x, w, bias, xe, we = _mlp_inputs()
    provider.requests = []
    ct.trace(True)
    xe.matmul(we).add(bias).relu()
    eager = [r.func for r in provider.requests]
    provider.requests = []
    _mlp_scope(xe, we, bias)
    ct.trace(False)
    assert [r.func for r in provider.requests] == eager and eager


# the tiny GPT of tests/test_torch_gpt.py (one block, batch 8)
TINY = dict(embed_dim=8, num_heads=2, num_blocks=1, vocab_size=32, seq_len=4)


def _tiny_gpt():
    import chip_smoke
    from curl_tpu_torch.models import GPT, load_numpy_state_dict

    ct.init(world_size=2, seed=5, device="cpu")
    sd = chip_smoke.random_gpt2_state(np.random.default_rng(0), TINY["seq_len"], 1, d=8,
                                      vocab=TINY["vocab_size"])
    model = load_numpy_state_dict(GPT(full=True, **TINY), sd)
    model.encrypt(src=0)
    tokens = np.random.default_rng(3).integers(0, TINY["vocab_size"], (8, TINY["seq_len"]))
    return model, ct.cryptensor(tokens.astype(np.float64), precision=0)


def test_tiny_gpt_in_a_scope_decodes_as_its_eager_forward():
    model, xe = _tiny_gpt()
    ct.reset_communication_stats()
    eager = model(xe).get_plain_text()
    eager_stats = ct.get_communication_stats()
    ct.reset_communication_stats()
    with ct.lazy() as tape:
        out = model(xe)
    assert ct.get_communication_stats() == eager_stats
    assert tape.flushes == 1 and tape.fallbacks == 0
    assert out.shape == (8, TINY["seq_len"], TINY["vocab_size"])
    np.testing.assert_allclose(out.get_plain_text(), eager, atol=0.1)


def _logreg(seed):
    """benchmarks/benchmark.py:267-268's logistic regression (Linear(20, 1),
    Sigmoid) at batch 16, its parameters encrypted and on the tape."""
    from curl_tpu_torch import nn, optim

    ct.init(world_size=2, seed=seed, device="cpu")
    rng = np.random.default_rng(DATA_SEED)
    X = rng.normal(size=(16, 20)) * 0.5
    y = (X[:, :1] > 0).astype(np.float64)
    model = nn.Sequential(nn.Linear(20, 1), nn.Sigmoid())
    model.encrypt(src=0)
    params = [p for _, p in model.named_parameters()]
    for p in params:
        p.requires_grad = True
    return model, params, optim.SGD(params, lr=0.1), nn.BCELoss(), ct.cryptensor(X), \
        ct.cryptensor(y)


def _train_step(model, opt, criterion, xe, ye):
    """benchmarks/benchmark.py:296-302's epoch body."""
    opt.zero_grad()
    loss = criterion(model(xe), ye)
    loss.backward()
    opt.step()
    return loss


def test_training_step_in_a_scope_as_the_eager_step():
    model, params, opt, crit, xe, ye = _logreg(11)
    eager_loss = _train_step(model, opt, crit, xe, ye).get_plain_text()
    eager_params = [p.get_plain_text() for p in params]
    model, params, opt, crit, xe, ye = _logreg(11)
    with ct.lazy() as tape:
        loss = _train_step(model, opt, crit, xe, ye)
        assert all(p._inner is None for p in params)  # each the pending update
        got_loss = float(loss.get_plain_text())  # forces completion
    assert tape.fallbacks == 0 and tape.flushes == 1
    np.testing.assert_allclose(got_loss, eager_loss, atol=0.02)
    for got, want in zip(params, eager_params):
        np.testing.assert_allclose(got.get_plain_text(), want, atol=0.01)


@pytest.mark.cuda
def test_scope_replays_as_compile_parties_on_the_card():
    """A scope captured and replayed on the card: bit-identical to the same
    forward through compile_parties at the flush's keys and counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a scope's flush is a captured graph there)")
    import chip_smoke
    from curl_tpu_torch.models import GPT, load_numpy_state_dict

    ct.init(world_size=2, seed=5)
    sd = chip_smoke.random_gpt2_state(np.random.default_rng(0), 16, 2, d=64, vocab=256)
    model = load_numpy_state_dict(GPT(64, 4, 2, 256, 16), sd)
    model.encrypt(src=0)
    tokens = np.random.default_rng(3).integers(0, 256, (1, 16))
    xe = ct.cryptensor(tokens.astype(np.float64), precision=0)
    outs = []
    for _ in range(2):  # the capture's flush, then a replay
        with ct.lazy() as tape:
            outs.append(model(xe))
    assert tape.program.captures == 1 and tape.fallbacks == 0
    apply_fn, params = model.functional()
    resume = trng.counter()
    trng.set_counter(tape.program.counter)
    want = ct.compile_parties(apply_fn, 2)(tape.seed, params, xe)
    trng.set_counter(resume)
    assert torch.equal(outs[1].share, want.share)
    assert not torch.equal(outs[0].share, outs[1].share)
