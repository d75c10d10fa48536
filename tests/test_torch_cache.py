"""The port's offline/online split against curl_tpu's, on the CPU.

Counterpart of tests/test_providers.py's cache tests, tests/test_compiled.py's
cached pipeline and tests/test_masked_operand.py's gate, for
``curl_tpu_torch/mpc/provider/provider.py`` (the tuple trace and cache),
``parallel/runner.py``'s ``compile_parties_cached`` and
``mpc/provider/dealer.py`` (the standalone dealer):

* the recorded request list of a mul, a gelu and a (4, 4) matmul equals
  curl_tpu's (function names, shapes and kwargs, in order; the fused knobs
  off, as curl_tpu has them off the TPU);
* a matmul and a product through both packages' ``compile_parties_cached``
  run, decoded against the plaintext and each other; the online's rounds
  and bytes, and those of the mul, gelu and matmul above, equal to
  curl_tpu's counted at trace (curl_tpu's cached gelu is only traced:
  compiling it costs tens of seconds here);
* in both packages a fill and an online call given one seed draw at
  different counters, so they never draw the same dealer-stream words;
* eager ops served from a host cache, successive entries, then
  "exhausted"; the cache and the request file on disk, no pickle read;
  the dealer's command line in a process of its own;
* ``mask_operand`` declines while recording and while serving;
* ``compile_parties_cached`` over the tiny compressed GPT of
  tests/test_torch_compiled.py under bench.py's kernel configuration:
  decoded within that file's tolerance of the uncached ``compile_parties``
  forward, its CommStats equal to it.

The streams differ (threefry there, Philox here): compare decoded values
and counts, never shares.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import curl_tpu  # noqa: E402
from curl_tpu import comm as jcomm  # noqa: E402
from curl_tpu import random as jrandom  # noqa: E402
from curl_tpu.parallel import compile_parties_cached as jcached  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import parallel  # noqa: E402
from curl_tpu_torch import random as trng  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.models import GPT  # noqa: E402
from curl_tpu_torch.mpc import get_default_provider  # noqa: E402
from curl_tpu_torch.mpc.primitives import beaver  # noqa: E402
from curl_tpu_torch.mpc.primitives.arithmetic import ArithmeticSharedTensor  # noqa: E402
from curl_tpu_torch.mpc.provider import dealer  # noqa: E402
from curl_tpu_torch.mpc.provider.provider import TupleCache  # noqa: E402

from test_torch_compiled import BENCH, GEOM, _state, _tokens  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_g = np.random.default_rng(11)
V, W = _g.normal(size=(4,)), _g.normal(size=(4,))
A, B = _g.normal(size=(4, 4)), _g.normal(size=(4, 4))
X, Y = _g.normal(size=(8, 8)) * 0.5, _g.normal(size=(8, 8)) * 0.5
TOKENS = np.array([1.0, 5.0, 7.0, 2.0])
TABLE = _g.normal(size=(8, 3))


def three_ops(v, w, a, b):
    return v.mul(w), v.gelu(), a.matmul(b)


def lin_fn(a, b):
    return a.matmul(b).mul(a)


def embed_fn(t, table):
    return t.evaluate_embed(table)


def _gelu(x):
    from math import erf

    return x * (1 + np.vectorize(erf)(x / np.sqrt(2))) / 2


def _stats(s):
    return s["rounds"], s["bytes"]


@pytest.fixture(scope="module")
def jax_side():
    """curl_tpu: the request list of three_ops, lin_fn's cached pipeline run
    compiled, the online CommStats of lin_fn and three_ops at trace, and the
    draw counters of embed_fn's fill and online traces."""
    curl_tpu.init(world_size=2, seed=3)
    provider = curl_tpu.get_default_provider()
    out = {}
    args = [curl_tpu.cryptensor(v).mpc for v in (V, W, A, B)]
    online, fill = jcached(three_ops, 2, 5, *args)
    out["requests"] = [(r.func, tuple(r.args), tuple(r.kwargs)) for r in provider.requests]
    entries = jax.eval_shape(fill, jax.random.PRNGKey(11))
    jcomm.reset_communication_stats()
    jax.eval_shape(online, jax.random.PRNGKey(12), entries, *args)
    out["three_ops"] = _stats(jcomm.get_communication_stats())

    xe, ye = curl_tpu.cryptensor(X).mpc, curl_tpu.cryptensor(Y).mpc
    online, fill = jcached(lin_fn, 2, 5, xe, ye)
    cache = fill(jax.random.PRNGKey(11))
    jcomm.reset_communication_stats()
    got = online(jax.random.PRNGKey(12), cache, xe, ye)
    out["lin"] = _stats(jcomm.get_communication_stats())
    out["lin_decoded"] = np.asarray(curl_tpu.CrypTensor(got).get_plain_text())

    tok = curl_tpu.cryptensor(TOKENS, precision=0).mpc
    table = curl_tpu.cryptensor(TABLE).mpc
    online, fill = jcached(embed_fn, 2, 5, tok, table)
    drawn, count = [], jrandom._next_count

    def logged():
        c = count()
        drawn.append(c)
        return c

    jrandom._next_count = logged
    try:
        entries = jax.eval_shape(fill, jax.random.PRNGKey(11))
        fill_counts = list(drawn)
        drawn.clear()
        jax.eval_shape(online, jax.random.PRNGKey(11), entries, tok, table)
    finally:
        jrandom._next_count = count
    out["embed_counters"] = (fill_counts, list(drawn))
    provider.requests = []
    return out


def _port_cached(fn, *values, seed=5, precisions=None):
    """The port's compile_parties_cached of ``fn`` on cryptensors of
    ``values`` (at ``precisions``, the default's where None): (online,
    fill, args)."""
    ct.init(world_size=2, seed=3, device="cpu")
    args = [ct.cryptensor(v, precision=p) for v, p in zip(values, precisions or [None] * 9)]
    online, fill = parallel.compile_parties_cached(fn, 2, seed, *args)
    return online, fill, args


def test_request_list_equals_curl_tpus(jax_side):
    _, fill, _ = _port_cached(three_ops, V, W, A, B)
    got = [(r.func, r.args, r.kwargs) for r in fill.requests]
    assert got == jax_side["requests"]
    assert [r.func for r in fill.requests] == fill.funcs
    assert get_default_provider().requests == fill.requests


@pytest.fixture(scope="module")
def port_lin():
    online, fill, args = _port_cached(lin_fn, X, Y)
    cache = fill(11)
    got = online(12, cache, *args)
    return dict(decoded=got.get_plain_text(), stats=_stats(online.stats), cache=cache,
                online=online, args=args)


@pytest.mark.parametrize("pkg", ["port", "curl_tpu"])
def test_cached_matmul_and_product_decode_to_the_plaintext(jax_side, port_lin, pkg):
    got = port_lin["decoded"] if pkg == "port" else jax_side["lin_decoded"]
    # tests/test_compiled.py::test_compiled_cached_pipeline's tolerance
    np.testing.assert_allclose(got, (X @ Y) * X, atol=0.05, rtol=0)


def test_cached_matmul_and_product_decode_like_curl_tpu(jax_side, port_lin):
    np.testing.assert_allclose(port_lin["decoded"], jax_side["lin_decoded"], atol=0.01, rtol=0)
    assert port_lin["cache"].cursor == len(port_lin["cache"].entries)


@pytest.mark.parametrize("cut,error", [(-1, "exhausted"), (1, "not the recorded ones")])
def test_online_serves_only_what_was_recorded(port_lin, cut, error):
    """A short cache raises and never draws a tuple inline; a long one is
    not the recorded stream either."""
    entries = port_lin["cache"].entries
    bad = TupleCache(entries[:cut] if cut < 0 else entries + entries[-cut:])
    with pytest.raises(RuntimeError, match=error):
        port_lin["online"](12, bad, *port_lin["args"])


@pytest.mark.parametrize("what", ["rounds", "bytes"])
@pytest.mark.parametrize("f", ["lin", "three_ops"])
def test_online_comm_stats_equal_curl_tpus_at_trace(jax_side, port_lin, f, what):
    i = ("rounds", "bytes").index(what)
    if f == "lin":
        got = port_lin["stats"]
    else:
        online, fill, args = _port_cached(three_ops, V, W, A, B)
        prod, gelu, mm = online(12, fill(11), *args)
        np.testing.assert_allclose(prod.get_plain_text(), V * W, atol=0.02, rtol=0)
        np.testing.assert_allclose(gelu.get_plain_text(), _gelu(V), atol=0.05, rtol=0)
        np.testing.assert_allclose(mm.get_plain_text(), A @ B, atol=0.05, rtol=0)
        got = _stats(online.stats)
    assert got[i] == jax_side[f][i]


@pytest.mark.parametrize("pkg", ["port", "curl_tpu"])
def test_fill_and_online_given_one_seed_draw_at_different_counters(jax_side, pkg):
    """Seed 11 for both, as tests/test_compiled.py:66-79 gives them: the
    online's rotated one-hot draws its r from the dealer stream outside the
    provider (_rotated_onehot_fast), the fill its triple's a and b. Equal
    keys, so equal counters would be equal words; each program draws from
    the counter of its first call, after the recording's, so they differ."""
    if pkg == "curl_tpu":
        fill_counts, online_counts = jax_side["embed_counters"]
    else:
        online, fill, (tok, table) = _port_cached(embed_fn, TOKENS, TABLE, precisions=[0, None])
        recorded = trng.counter()
        cache = fill(11)
        fill_counts = range(fill.program.counter, trng.counter())
        got = online(11, cache, tok, table)
        online_counts = range(online.counter, trng.counter())
        assert fill.program.counter == recorded
        np.testing.assert_allclose(got.get_plain_text(), TABLE[TOKENS.astype(int)], atol=2 ** -12)
    assert fill_counts and online_counts
    assert not set(fill_counts) & set(online_counts)


# ---------------------------------------------------------------------------
# eager ops and the host cache (tests/test_providers.py:76-170)
# ---------------------------------------------------------------------------

@pytest.fixture
def session():
    ct.init(world_size=2, seed=7, device="cpu")
    provider = get_default_provider()
    provider.requests = []
    yield provider
    ct.trace(False)
    provider.attach_cache(None)
    provider.requests = []


def _mul(x, y):
    return (ct.cryptensor(x) * ct.cryptensor(y)).get_plain_text()


def test_tuple_trace_and_cache(session):
    ct.trace(True)
    _mul(V, W)
    ct.trace(False)
    assert [r.func for r in session.requests] == ["generate_additive_triple", "egk_trunc_pr_rng"]
    counter = trng.counter()
    cache = ct.fill_cache(seed=3)
    assert len(cache.entries) == len(session.requests) and trng.counter() > counter
    np.testing.assert_allclose(_mul(V, W), V * W, atol=0.02)
    assert cache.cursor == len(cache.entries)
    ct.trace_once()  # requests are recorded already
    assert not session.tracing


def test_cached_eager_ops_advance_cursor(session):
    """Successive eager ops pop distinct entries (reusing entry 0's mask
    across secrets would leak x1 - x2) and the op after the last raises."""
    ct.trace(True)
    _mul(V, W)
    _mul(A[0], B[0])
    ct.trace(False)
    cache = ct.fill_cache()
    assert cache.cursor == 0 and len(cache.entries) == 4
    out1 = _mul(V, W)
    assert cache.cursor == 2
    out2 = _mul(A[0], B[0])
    assert cache.cursor == 4
    np.testing.assert_allclose(out1, V * W, atol=0.02)
    np.testing.assert_allclose(out2, A[0] * B[0], atol=0.02)
    # distinct tuples: the two triples' a differ
    assert not torch.equal(cache.entries[0][0].share, cache.entries[2][0].share)
    with pytest.raises(RuntimeError, match="exhausted"):
        _mul(V, W)


def test_cache_disk_roundtrip(session, tmp_path):
    ct.trace(True)
    _mul(V, W)
    ct.cryptensor(V).gelu().get_plain_text()
    ct.trace(False)
    ct.fill_cache()
    path = str(tmp_path / "tuples.npz")
    session.save_cache(path)
    session.attach_cache(None)
    with np.load(path, allow_pickle=False) as data:  # every array plain
        assert all(data[k].dtype != object for k in data.files)
    cache = session.load_cache(path)
    assert cache.cursor == 0 and cache.funcs == [r.func for r in session.requests]
    np.testing.assert_allclose(_mul(V, W), V * W, atol=0.02)
    np.testing.assert_allclose(ct.cryptensor(V).gelu().get_plain_text(), _gelu(V), atol=0.05)
    assert cache.cursor == len(cache.entries)

    reqs = str(tmp_path / "requests.json")
    session.save_requests(reqs)
    kept = session.requests
    session.load_requests(reqs)
    assert session.requests == kept


def test_tampered_request_and_cache_files_are_rejected_unexecuted(session, tmp_path):
    import json
    import pickle

    marker = tmp_path / "executed"

    class Evil:
        def __reduce__(self):
            return (open, (str(marker), "w"))

    evil = tmp_path / "requests.pkl"
    evil.write_bytes(pickle.dumps([Evil()]))
    named = tmp_path / "named.json"
    named.write_text(json.dumps({"format": "curl_tpu_torch tuple requests", "version": 1,
                                 "requests": [{"func": "__init__", "args": [], "kwargs": {}}]}))
    typed = tmp_path / "typed.json"
    typed.write_text(json.dumps({"format": "curl_tpu_torch tuple requests", "version": 1,
                                 "requests": [{"func": "square", "args": [{"a": 1}],
                                               "kwargs": {}}]}))
    for path in (evil, named, typed):
        with pytest.raises(ValueError):
            session.load_requests(str(path))
    bad_cache = tmp_path / "cache.npz"
    np.savez(bad_cache, __meta__=np.array([Evil()], dtype=object))
    with pytest.raises(ValueError):
        session.load_cache(str(bad_cache))
    assert not marker.exists() and session.requests == []


def test_dealer_command_line_and_party_files(session, tmp_path):
    """tests/test_providers.py:178-240: requests recorded, the dealer's
    command line run in a process of its own (--device cpu), each party's
    file loaded, the same ops served from them."""
    ct.trace(True)
    _mul(V, W)
    ct.cryptensor(V).gelu().get_plain_text()
    ct.trace(False)
    reqs, prefix = str(tmp_path / "requests.json"), str(tmp_path / "tuples")
    session.save_requests(reqs)
    proc = subprocess.run(
        [sys.executable, "-m", "curl_tpu_torch.mpc.provider.dealer", "--requests", reqs,
         "--world-size", "2", "--seed", "1234", "--out", prefix, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr
    paths = [f"{prefix}.party{r}.npz" for r in range(2)]
    assert proc.stdout.split() == paths
    # each file holds its party's slice; party 0's the dealer plaintexts too
    with np.load(paths[0]) as p0, np.load(paths[1]) as p1:
        assert len(p1.files) < len(p0.files)
    cache = dealer.attach_party_caches(paths[::-1])
    assert cache.cursor == 0
    np.testing.assert_allclose(_mul(V, W), V * W, atol=0.02)
    np.testing.assert_allclose(ct.cryptensor(V).gelu().get_plain_text(), _gelu(V), atol=0.05)
    assert cache.cursor == len(cache.entries)
    with pytest.raises(ValueError, match="duplicate"):
        dealer.load_party_caches([paths[0], paths[0]])
    with pytest.raises(ValueError, match="missing"):
        dealer.load_party_caches([paths[1]])


def test_dealer_runs_on_the_card_unless_told_otherwise(session, tmp_path, monkeypatch):
    reqs = str(tmp_path / "requests.json")
    session.save_requests(reqs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dealer.main(["--requests", reqs, "--world-size", "2", "--out", str(tmp_path / "t")])


# ---------------------------------------------------------------------------
# the gate that must agree between recording and serving
# (tests/test_masked_operand.py:62-87)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flow", ["none", "recording", "serving", "host cache"])
def test_mask_operand_declines_under_cache_flows(session, flow):
    x = ArithmeticSharedTensor(torch.zeros((2, 3), dtype=torch.int64), ct.FixedPointEncoder(0))
    if flow == "recording":
        session.trace(True)
        declined = beaver.mask_operand(x) is x
    elif flow == "serving":
        with session.serving(TupleCache([])):
            declined = beaver.mask_operand(x) is x
    elif flow == "host cache":
        session.attach_cache(TupleCache([]))
        declined = beaver.mask_operand(x) is x
    else:
        declined = beaver.mask_operand(x) is x
    assert declined == (flow != "none")


# ---------------------------------------------------------------------------
# the tiny compressed GPT of tests/test_torch_compiled.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gpt():
    with cfg.temp_override(BENCH):
        ct.init(world_size=2, seed=21, device="cpu")
        model = GPT.build_compressed(**GEOM, head_vocab_chunks=4, chunk_block_linears=True,
                                     state_dict=_state(0))
        xe = ct.cryptensor(_tokens(), precision=0)
        apply_fn, params = model.functional()
        online, fill = parallel.compile_parties_cached(apply_fn, 2, 99, params, xe)
        cache = fill(97)
        first = online(101, cache, params, xe)
        again = online(101, cache, params, xe)
        other = online(101, fill(98), params, xe)
        step = parallel.compile_parties(apply_fn, 2)
        plain = step(101, params, xe)
    return dict(online=online, fill=fill, cache=cache, first=first, again=again, other=other,
                step=step, plain=plain)


def test_cached_gpt_decodes_like_the_uncached_forward(gpt):
    got = gpt["first"].get_plain_text()
    assert got.shape == (1, 8, 64) and np.isfinite(got).all()
    # tests/test_torch_compiled.py's tolerance between two seeds
    np.testing.assert_allclose(got, gpt["plain"].get_plain_text(), atol=0.06)
    np.testing.assert_allclose(gpt["other"].get_plain_text(), got, atol=0.06)


def test_cached_gpt_comm_stats_equal_the_uncached_forwards(gpt):
    assert gpt["online"].stats == gpt["step"].stats
    assert gpt["fill"].program.stats["rounds"] == 0  # no TFP call communicates at 2 parties


def test_cached_gpt_same_cache_twice_identical_two_caches_different(gpt):
    assert torch.equal(gpt["first"].share, gpt["again"].share)
    assert not torch.equal(gpt["first"].share, gpt["other"].share)
    assert gpt["online"].captures == 1 and gpt["fill"].program.captures == 1
    assert gpt["cache"].cursor == len(gpt["cache"].entries) == len(gpt["fill"].requests)



# ---------------------------------------------------------------------------
# a fault of the reference, not reproduced: a lax.scan body recorded once
# ---------------------------------------------------------------------------

SCAN = {"functions.max_method": "scan_reduction", "functions.scan_fixed_width": 4}
SCAN_X = np.random.default_rng(5).normal(size=(2, 16))
SELECT = ("generate_additive_triple", ((2, 4), (2, 4), "mul"))


def max_fn(a):
    out = a.max(dim=-1)
    return out[0] if isinstance(out, tuple) else out


def test_curl_tpu_serves_one_scan_body_entry_to_every_iteration():
    """scan_reduction's fold of (2, 16) in chunks of 4: a select product a
    step. curl_tpu records 2, the step before its lax.scan and the scan body
    once, so its online serves the body's one triple to all 4 iterations
    (Beaver masks reused across iterations); the port's fold is a loop and
    records, and is served, a triple a step."""
    curl_tpu.init(world_size=2, seed=3)
    with curl_tpu.cfg.temp_override(SCAN):
        jcached(max_fn, 2, 5, curl_tpu.cryptensor(SCAN_X).mpc)
    theirs = [(r.func, tuple(r.args)) for r in curl_tpu.get_default_provider().requests]
    curl_tpu.get_default_provider().requests = []
    with cfg.temp_override(SCAN):
        online, fill, (x,) = _port_cached(max_fn, SCAN_X)
        got = online(7, fill(6), x).get_plain_text()
    ours = [(r.func, r.args) for r in fill.requests]
    assert (theirs.count(SELECT), ours.count(SELECT)) == (2, 5)
    np.testing.assert_allclose(got, SCAN_X.max(-1), atol=2 ** -12)
