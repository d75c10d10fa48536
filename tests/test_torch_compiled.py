"""The port's party runtimes (``curl_tpu_torch.parallel``) against curl_tpu's.

Counterpart of tests/test_compiled.py, on the CPU (``device="cpu"``): there
``compile_parties`` runs its function eagerly under each call's keys, from
the draw counter of its first call, which is what a replay of the captured
CUDA graph computes on a card (chip_smoke.py's phase 6 holds the graph to
it, share for share).

* A function of a matmul, a product and exp through both packages'
  ``compile_parties`` and ``run_parties``: decoded values against the
  plaintext within curl_tpu's own exp tolerance and against each other, and
  rounds and bytes equal to curl_tpu's counted at trace
  (``jax.make_jaxpr``); the same with gelu, whose counts are compared and
  whose values are held to the plaintext (curl_tpu's compiled gelu takes a
  minute to compile on a CPU, so it is only traced).
* ``Module.functional()`` of a tiny seed-compressed GPT under bench.py's
  kernel configuration: a call at seed s equal, share for share, to an
  eager forward under the keys of s from the capture's draw counter; the
  same seed twice identical, two seeds different; the session's keys and
  counter restored; CommStats counted once; a new compressed key or a new
  shape captures anew, and a forward makes no tensor from host data once
  its constants are made.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import curl_tpu  # noqa: E402
from curl_tpu import comm as jcomm  # noqa: E402
from curl_tpu.parallel import compile_parties as jcompile  # noqa: E402
from curl_tpu.parallel import run_parties as jrun  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import parallel  # noqa: E402
from curl_tpu_torch import random as trng  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.models import GPT  # noqa: E402

_g = np.random.default_rng(7)
X = _g.normal(size=(8, 8)) * 0.5
Y = _g.normal(size=(8, 8)) * 0.5


def exp_fn(a, b):
    return a.matmul(b).mul(a).exp()


def gelu_fn(a, b):
    return a.matmul(b).mul(a).gelu()


def _plain(name):
    z = (X @ Y) * X
    if name == "exp":
        return np.exp(z)
    from math import erf

    return z * (1 + np.vectorize(erf)(z / np.sqrt(2))) / 2


FNS = {"exp": exp_fn, "gelu": gelu_fn}


def _jax_counts(fn, runner):
    curl_tpu.init(world_size=2, seed=3)
    x, y = curl_tpu.cryptensor(X), curl_tpu.cryptensor(Y)
    jcomm.reset_communication_stats()
    if runner == "compile_parties":
        jax.make_jaxpr(jcompile(fn, 2))(jax.random.PRNGKey(5), x.mpc, y.mpc)
    else:
        jax.make_jaxpr(lambda k, a, b: jrun(fn, 2, k, a, b))(jax.random.PRNGKey(5), x.mpc, y.mpc)
    s = jcomm.get_communication_stats()
    return s["rounds"], s["bytes"]


@pytest.fixture(scope="module")
def jax_runs():
    """curl_tpu: exp_fn decoded through both runners, and every (function,
    runner)'s rounds and bytes at trace."""
    curl_tpu.init(world_size=2, seed=3)
    x, y = curl_tpu.cryptensor(X), curl_tpu.cryptensor(Y)
    decoded = {
        "compile_parties": curl_tpu.CrypTensor(
            jcompile(exp_fn, 2)(jax.random.PRNGKey(5), x.mpc, y.mpc)).get_plain_text(),
        "run_parties": curl_tpu.CrypTensor(
            jrun(exp_fn, 2, jax.random.PRNGKey(6), x.mpc, y.mpc)).get_plain_text(),
    }
    counts = {(f, r): _jax_counts(fn, r) for f, fn in FNS.items()
              for r in ("compile_parties", "run_parties")}
    return decoded, counts


@pytest.fixture(scope="module")
def port_runs():
    """The port: each function through both runners, decoded, with the
    rounds and bytes the runner counted."""
    out = {}
    for f, fn in FNS.items():
        for runner in ("compile_parties", "run_parties"):
            ct.init(world_size=2, seed=3, device="cpu")
            x, y = ct.cryptensor(X), ct.cryptensor(Y)
            ct.reset_communication_stats()
            if runner == "compile_parties":
                step = parallel.compile_parties(fn, 2)
                got = step(5, x, y)
                assert step.captures == 1
                counted = (step.stats["rounds"], step.stats["bytes"])
            else:
                got = parallel.run_parties(fn, 2, 6, x, y)
                s = ct.get_communication_stats()
                counted = (s["rounds"], s["bytes"])
            out[(f, runner)] = (got.get_plain_text(), counted)
    return out


@pytest.mark.parametrize("runner", ["compile_parties", "run_parties"])
@pytest.mark.parametrize("pkg", ["port", "curl_tpu"])
def test_exp_decodes_within_curl_tpus_tolerance(jax_runs, port_runs, pkg, runner):
    got = port_runs[("exp", runner)][0] if pkg == "port" else jax_runs[0][runner]
    # tests/test_functions.py::test_exp_limit_method's tolerance
    np.testing.assert_allclose(got, _plain("exp"), rtol=0.03, atol=0.01)


@pytest.mark.parametrize("runner", ["compile_parties", "run_parties"])
def test_exp_decodes_like_curl_tpu(jax_runs, port_runs, runner):
    np.testing.assert_allclose(port_runs[("exp", runner)][0], jax_runs[0][runner],
                               rtol=0.06, atol=0.02)


@pytest.mark.parametrize("runner", ["compile_parties", "run_parties"])
def test_gelu_decodes_within_curl_tpus_tolerance(port_runs, runner):
    # tests/test_functions.py::test_gelu_domain's tolerance
    np.testing.assert_allclose(port_runs[("gelu", runner)][0], _plain("gelu"), atol=0.05, rtol=0)


@pytest.mark.parametrize("what", ["rounds", "bytes"])
@pytest.mark.parametrize("runner", ["compile_parties", "run_parties"])
@pytest.mark.parametrize("f", sorted(FNS))
def test_comm_stats_equal_curl_tpus_at_trace(jax_runs, port_runs, f, runner, what):
    i = ("rounds", "bytes").index(what)
    assert port_runs[(f, runner)][1][i] == jax_runs[1][(f, runner)][i]


def test_public_arguments_and_jit_false():
    ct.init(world_size=2, seed=4, device="cpu")
    x = ct.cryptensor(X)

    def scale(a, k, w):
        return a.mul(k).add(w)

    w = torch.from_numpy(Y)
    for step in (parallel.compile_parties(scale, 2), parallel.compile_parties(scale, 2, jit=False)):
        got = step(1, x, parallel.Public(3), parallel.Public(w)).get_plain_text()
        np.testing.assert_allclose(got, 3 * X + Y, atol=1e-3)
    with pytest.raises(TypeError):
        parallel.compile_parties(scale, 2)(1, x, 3, np.ones(3))  # a graph cannot key on it


def test_mpc_context_binds_and_restores_keys_and_world_size():
    ct.init(world_size=2, seed=4, device="cpu")
    session = trng.current_keys()
    keys = trng.make_party_keys(99, 3)
    with parallel.mpc_context(keys, 3):
        assert ct.comm.get_world_size() == 3 and trng.current_keys() is keys
        assert trng.TABLE.host[trng.SLOTS["fused"]] == keys["fused"][0]
    assert ct.comm.get_world_size() == 2 and trng.current_keys() is session
    assert trng.TABLE.host[trng.SLOTS["dealer"]] == session["dealer"][0]
    with pytest.raises(NotImplementedError):
        with parallel.mpc_context(keys, 2, runtime="shard_map"):
            pass


@pytest.mark.parametrize("name,args,item", [
    ("run_parties_spmd", (None, 2, 0), "A15"), ("shard_map_parties", (None, 2), "A15")])
def test_unported_runners_name_their_queue_item(name, args, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        getattr(parallel, name)(lambda a: a, *args)


# ---------------------------------------------------------------------------
# Module.functional() of a tiny seed-compressed GPT
# ---------------------------------------------------------------------------

GEOM = dict(embed_dim=16, num_heads=2, num_blocks=1, vocab_size=64, seq_len=8)
BENCH = {"functions.max_method": "scan_reduction", "mpc.fused_mul": "cuda",
         "mpc.fused_trunc": "cuda", "mpc.fused_compare": "cuda", "mpc.fused_max_step": "cuda"}


def _tokens(n=8):
    return np.random.default_rng(1).integers(0, 64, size=(1, n)).astype(np.float64)


def _state(seed):
    import chip_smoke

    return chip_smoke.random_gpt2_state(np.random.default_rng(seed), 8, 1, d=16, vocab=64)


@contextlib.contextmanager
def _no_host_data():
    """Fail on any tensor made from host data: what a captured forward
    cannot do."""
    def refuse(*a, **k):
        raise AssertionError("a forward made a tensor from host data")

    saved = torch.tensor, torch.as_tensor, torch.from_numpy
    torch.tensor = torch.as_tensor = torch.from_numpy = refuse
    try:
        yield
    finally:
        torch.tensor, torch.as_tensor, torch.from_numpy = saved


@pytest.fixture(scope="module")
def gpt():
    with cfg.temp_override(BENCH):
        ct.init(world_size=2, seed=21, device="cpu")
        model = GPT.build_compressed(**GEOM, head_vocab_chunks=4, chunk_block_linears=True,
                                     state_dict=_state(0))
        xe = ct.cryptensor(_tokens(), precision=0)
        apply_fn, params = model.functional()
        step = parallel.compile_parties(apply_fn, 2)
        session = dict(trng.current_keys())
        ct.reset_communication_stats()
        before = trng.counter()
        first = step(5, params, xe)
        after_first = trng.counter()
        stats = ct.get_communication_stats()
        with _no_host_data():
            again = step(5, params, xe)
        other = step(6, params, xe)
        stats_after = ct.get_communication_stats()
        counter_after = trng.counter()
        # the same forward eagerly, under the keys of seed 5 from the
        # capture's draw counter
        trng.set_counter(step.counter)
        with parallel.mpc_context(trng.make_party_keys(5, 2), 2):
            eager = model(xe)
        trng.set_counter(counter_after)
        # the session draws as if no call had run... from its own counter
        probe = trng.random_ring((4,), "local")
    yield dict(model=model, xe=xe, step=step, params=params, session=session, first=first,
               again=again, other=other, eager=eager, stats=stats, stats_after=stats_after,
               before=before, after_first=after_first, counter_after=counter_after,
               probe=probe)


def test_functional_call_equals_eager_forward(gpt):
    assert torch.equal(gpt["first"].share, gpt["eager"].share)
    np.testing.assert_array_equal(gpt["first"].get_plain_text(), gpt["eager"].get_plain_text())


def test_functional_output_is_finite_and_a_distribution(gpt):
    probs = gpt["first"].get_plain_text()
    assert probs.shape == (1, 8, 64) and np.isfinite(probs).all()


def test_same_seed_twice_is_identical(gpt):
    assert torch.equal(gpt["first"].share, gpt["again"].share)


def test_two_seeds_draw_different_shares(gpt):
    assert not torch.equal(gpt["first"].share, gpt["other"].share)
    # the same secret underneath: only the masks differ
    np.testing.assert_allclose(gpt["first"].get_plain_text(), gpt["other"].get_plain_text(),
                               atol=0.06)


def test_session_keys_and_counter_restored(gpt):
    assert trng.current_keys() == gpt["session"]
    for name, slot in trng.SLOTS.items():
        vals = gpt["session"][name]
        assert trng.TABLE.host[slot:slot + len(vals)] == list(vals), name
    # the capture leaves the counter after one forward; later calls none
    assert gpt["after_first"] > gpt["before"] == gpt["step"].counter
    assert gpt["counter_after"] == gpt["after_first"]
    trng.set_counter(gpt["counter_after"])
    with parallel.mpc_context(gpt["session"], 2):
        assert torch.equal(trng.random_ring((4,), "local"), gpt["probe"])


def test_comm_stats_counted_once_at_capture(gpt):
    assert gpt["stats_after"] == gpt["stats"]
    assert (gpt["step"].stats["rounds"], gpt["step"].stats["bytes"]) == (
        gpt["stats"]["rounds"], gpt["stats"]["bytes"])
    assert gpt["step"].captures == 1


@pytest.mark.parametrize("change", ["compressed key", "shape"])
def test_a_changed_key_or_shape_captures_anew(gpt, change):
    step = gpt["step"]
    n = step.captures
    with cfg.temp_override(BENCH):
        if change == "compressed key":
            model = GPT.build_compressed(**GEOM, head_vocab_chunks=4, chunk_block_linears=True,
                                         state_dict=_state(0))
            apply_fn, params = model.functional()
            out = step(5, params, gpt["xe"])
            assert step.captures == n + 1
            # the same weights under other keys: the same decoded output
            np.testing.assert_allclose(out.get_plain_text(), gpt["first"].get_plain_text(),
                                       atol=0.06)
        else:
            xe = ct.cryptensor(_tokens(4), precision=0)
            out = step(5, gpt["params"], xe)
            assert step.captures == n + 1 and out.shape == (1, 4, 64)
            step(5, gpt["params"], xe)
            assert step.captures == n + 1  # that shape's capture is reused


def test_arguments_are_read_in_place_until_they_move(monkeypatch):
    # on a card a tensor argument is read in place, at its address; one that
    # comes at another address is captured anew once and read through a
    # static buffer from then on (the capture and the replay stubbed: no
    # card here; the bookkeeping is the runner's own)
    from curl_tpu_torch.parallel import runner

    ct.init(world_size=2, seed=3, device="cpu")
    captured, counters = [], []

    def capture(self, key, spec, leaves, staged, keys, device, counter):
        entry = runner._Capture(counter)
        runner._stage(entry, leaves, staged, "cpu")
        captured.append(set(staged))
        counters.append(counter)
        trng.set_counter(counter + 100)  # as a capture's forward draws
        self._record(key, entry, runner._counts())
        return entry

    monkeypatch.setattr(runner.CompiledParties, "_capture", capture)
    monkeypatch.setattr(runner.CompiledParties, "_replay",
                        lambda self, entry, leaves, keys: set(entry.staged))
    monkeypatch.setattr(runner.comm, "get_device", lambda: torch.device("cuda"))
    step = parallel.compile_parties(lambda w, x: None, 2)
    w, x = torch.zeros(4, dtype=torch.int64), torch.ones(3, dtype=torch.int64)
    assert step(1, w, x) == set() and captured == [set()]
    assert step(2, w, x) == set() and len(captured) == 1
    assert step(3, w, x.clone()) == {1} and captured[-1] == {1}
    assert step(4, w, x.clone()) == {1} and len(captured) == 2
    assert step(5, w.clone(), x) == {0, 1} and len(captured) == 3
    assert step(6, w.clone(), x.clone()) == {0, 1} and step.captures == 3
    # a capture anew for a moved argument draws at the first capture's
    # counters, so a call's shares do not depend on where its tensors lie
    assert counters == [counters[0]] * 3


def test_a_runners_constants_outlive_the_shared_cache():
    from curl_tpu_torch import ring

    held = {}
    with ring.holding_constants(held):
        t = ring.host_constant(np.arange(5), "cpu")
    for i in range(ring.MAX_CONSTANTS + 1):  # evicts it from the shared cache
        ring.host_constant(np.full(3, i), "cpu")
    assert ring.host_constant(np.arange(5), "cpu") is not t
    with ring.holding_constants(held):
        assert ring.host_constant(np.arange(5), "cpu") is t
    assert len(held) == 1
