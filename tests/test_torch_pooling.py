"""The port's pooling, structure ops, dropout and sampling against curl_tpu.

* ``_sum_pool2d`` (avg_pool2d's window sums of shares, zero shares in the
  padding) equals curl_tpu's share for share; avg_pool2d, max_pool2d and
  the adaptive pools decode within the reference's tolerance
  (tests/test_mpc_sweep.py's 0.01) of float64;
* max_pool2d: rounds and bytes equal curl_tpu's (traced, under the
  default ``log_reduction``, which has no scan to weight); at
  ``mpc.compare_bits`` 64, where curl_tpu's pad is ordered, the decoded
  windows equal curl_tpu's within 0.01 under ``scan_reduction``;
* the pad fault of the reference (ROADMAP Queue C): at the default 32-bit
  compare curl_tpu's -2^24 pad wins every window whose real entries are at
  most 0, and decodes there as -2^24; the port's pad does not, and the port
  given curl_tpu's pad reproduces the fault at the same rounds and bytes;
* regular.py's flip, gather, take, repeat, unfold, trace, chunk and unbind
  equal curl_tpu's share for share; dot and ger decode within 0.05 of
  float64 at curl_tpu's rounds and bytes;
* dropout, bernoulli, randn and weighted_sample: rounds and bytes equal
  curl_tpu's (traced), their draws distributed as the reference's.
"""

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
from curl_tpu.encoder import FixedPointEncoder as JEncoder  # noqa: E402
from curl_tpu.mpc.primitives.arithmetic import ArithmeticSharedTensor as JArith  # noqa: E402
from curl_tpu.parallel import run_parties as jrun  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.encoder import FixedPointEncoder as TEncoder  # noqa: E402
from curl_tpu_torch.functions import pooling  # noqa: E402
from curl_tpu_torch.mpc.primitives.arithmetic import ArithmeticSharedTensor as TArith  # noqa: E402

F = torch.nn.functional
_rng = np.random.default_rng(2024)
X = _rng.normal(size=(1, 2, 7, 6)) * 2
# the reference's probe: a ReLU'd input with one 2 x 2 corner zeroed
RELU_X = np.maximum(np.random.default_rng(3).normal(size=(1, 8, 8, 8)), 0)
RELU_X[..., :2, :2] = 0
PAD = -(2.0 ** 24)


def _port_counts(fn, *values, config=None):
    ct.init(world_size=2, seed=1234, device="cpu")
    enc = [ct.cryptensor(v) for v in values]
    with cfg.temp_override(config or {}):
        ct.reset_communication_stats()
        out = fn(*enc)
        stats = ct.get_communication_stats()
    return out, (stats["rounds"], stats["bytes"])


def _curl_tpu_counts(fn, *values, config=None):
    curl_tpu.init(world_size=2, seed=1234)
    enc = [curl_tpu.cryptensor(v).mpc for v in values]
    with curl_tpu.cfg.temp_override(config or {}):
        jcomm.reset_communication_stats()
        jax.make_jaxpr(lambda k, *a: jrun(fn, 2, k, *a))(jax.random.PRNGKey(5), *enc)
        stats = jcomm.get_communication_stats()
    return stats["rounds"], stats["bytes"]


def _curl_tpu_decoded(fn, *values, config=None):
    curl_tpu.init(world_size=2, seed=1234)
    enc = [curl_tpu.cryptensor(v).mpc for v in values]
    with curl_tpu.cfg.temp_override(config or {}):
        out = jrun(fn, 2, jax.random.PRNGKey(6), *enc, jit=True)  # one compile, not one an op
        return np.asarray(curl_tpu.CrypTensor(out).get_plain_text())


def _shares(shape, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 64, size=(2,) + shape, dtype=np.uint64)


def _same_shares(port_fn, jax_fn, shape, seed=0):
    """A structure op on random shares: the port's (P, ...) share against
    curl_tpu's op on each party's share."""
    sh = _shares(shape, seed)
    got = port_fn(TArith(torch.from_numpy(sh.view(np.int64)), TEncoder()))
    gots = got if isinstance(got, list) else [got]
    for p in range(2):
        want = jax_fn(JArith(jnp.asarray(sh[p]), JEncoder()))
        wants = want if isinstance(want, list) else [want]
        assert len(gots) == len(wants)
        for g, w in zip(gots, wants):
            np.testing.assert_array_equal(g.share[p].numpy().view(np.uint64), np.asarray(w.share))


@pytest.mark.parametrize("kernel,stride,padding", [(2, None, 0), (3, 2, 1), ((3, 2), (2, 1), (1, 0))])
def test_sum_pool_shares_equal_curl_tpu(kernel, stride, padding):
    _same_shares(lambda t: t._sum_pool2d(kernel, stride=stride, padding=padding),
                 lambda t: t._sum_pool2d(kernel, stride=stride, padding=padding), (1, 2, 7, 6))


POOLS = {
    "avg_pool2d": (lambda a: a.avg_pool2d(2), lambda v: F.avg_pool2d(v, 2)),
    "avg_pool2d-pad": (lambda a: a.avg_pool2d(3, stride=2, padding=1),
                       lambda v: F.avg_pool2d(v, 3, stride=2, padding=1)),
    "max_pool2d": (lambda a: a.max_pool2d(2), lambda v: F.max_pool2d(v, 2)),
    "max_pool2d-pad": (lambda a: a.max_pool2d(3, stride=2, padding=1),
                       lambda v: F.max_pool2d(v, 3, stride=2, padding=1)),
    "max_pool2d-ceil": (lambda a: a.max_pool2d(2, ceil_mode=True),
                        lambda v: F.max_pool2d(v, 2, ceil_mode=True)),
    "adaptive_avg_pool2d": (lambda a: a.adaptive_avg_pool2d((1, 1)),
                            lambda v: F.adaptive_avg_pool2d(v, (1, 1))),
    "adaptive_max_pool2d": (lambda a: a.adaptive_max_pool2d((3, 2)),
                            lambda v: F.adaptive_max_pool2d(v, (3, 2))),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pool_decodes_as_float64(name):
    fn, plain = POOLS[name]
    out, _ = _port_counts(fn, X)
    np.testing.assert_allclose(out.get_plain_text(), plain(torch.tensor(X)).numpy(), atol=0.01)


@pytest.mark.parametrize("name", ["max_pool2d-pad", "adaptive_max_pool2d"])
def test_max_pool_rounds_and_bytes_equal_curl_tpu(name):
    fn, _ = POOLS[name]
    assert _port_counts(fn, X)[1] == _curl_tpu_counts(fn, X)


def _fault_windows(out):
    return int((np.abs(out - PAD) < 1).sum())


@pytest.fixture(scope="module")
def resnet_pool_runs():
    """curl_tpu's decoded max_pool2d(3, 2, 1) of the probe under
    scan_reduction at 32- and 64-bit compares."""
    fn = POOLS["max_pool2d-pad"][0]
    return {w: _curl_tpu_decoded(fn, RELU_X, config={"functions.max_method": "scan_reduction",
                                                     "mpc.compare_bits": w})
            for w in (32, 64)}


def test_max_pool_at_64_bit_compares_equals_curl_tpu(resnet_pool_runs):
    fn, plain = POOLS["max_pool2d-pad"]
    out, _ = _port_counts(fn, RELU_X, config={"functions.max_method": "scan_reduction",
                                              "mpc.compare_bits": 64})
    np.testing.assert_allclose(out.get_plain_text(), resnet_pool_runs[64], atol=0.01)
    np.testing.assert_allclose(resnet_pool_runs[64], plain(torch.tensor(RELU_X)).numpy(), atol=0.01)


def test_max_pool_pad_fault_of_the_reference(resnet_pool_runs, monkeypatch):
    """At the default 32-bit packed compare, curl_tpu's -2^24 pad encodes to
    -2^40, 0 mod 2^32: it ties or beats every real entry at most 0, so each
    of the 8 channels' corner window (all zeros here) decodes as -2^24. The
    port's pad of -2^(32-2-16) is ordered there; the port given curl_tpu's
    pad reproduces the fault, at the same rounds and bytes."""
    fn, plain = POOLS["max_pool2d-pad"]
    ref = plain(torch.tensor(RELU_X)).numpy()
    config = {"functions.max_method": "scan_reduction"}
    theirs = resnet_pool_runs[32]
    assert _fault_windows(theirs[..., :1, :1]) == 8  # every corner window
    assert _fault_windows(theirs) >= 8
    ours, counts = _port_counts(fn, RELU_X, config=config)
    assert _fault_windows(ours.get_plain_text()) == 0
    np.testing.assert_allclose(ours.get_plain_text(), ref, atol=0.01)
    monkeypatch.setattr(pooling, "_max_pad", lambda encoder: PAD)
    reproduced, fault_counts = _port_counts(fn, RELU_X, config=config)
    assert _fault_windows(reproduced.get_plain_text()[..., :1, :1]) == 8
    assert counts == fault_counts


def test_max_pad_is_ordered_by_each_compare_width():
    """-2^(w-2) ring units against the real values the packed compare
    orders; curl_tpu's -2^24 at w = 64."""
    ct.init(world_size=2, seed=0, device="cpu")
    enc = TEncoder()
    for width, pad in ((16, -0.25), (32, -16384.0), (64, PAD)):
        with cfg.temp_override({"mpc.compare_bits": width}):
            assert pooling._max_pad(enc) == pad


STRUCTURE = {
    "flip": (lambda t: t.flip((1, 2)), (3, 4, 5)),
    "gather": (lambda t: t.gather(1, np.array([[[0, 2, 1, 0, 3]] * 2] * 3)), (3, 4, 5)),
    "take": (lambda t: t.take(np.array([[0, 7], [59, 3]])), (3, 4, 5)),
    "take-dim": (lambda t: t.take(np.array([3, 0]), 2), (3, 4, 5)),
    "repeat": (lambda t: t.repeat(2, 1, 3), (4, 5)),
    "repeat-more": (lambda t: t.repeat(2, 1, 1, 2), (4, 5)),
    "unfold": (lambda t: t.unfold(2, 2, 2), (3, 4, 5)),
    "trace": (lambda t: t.trace(), (4, 4)),
    "chunk": (lambda t: t.chunk(3, 1), (3, 7, 2)),
    "unbind": (lambda t: t.unbind(1), (3, 4, 2)),
}


@pytest.mark.parametrize("name", sorted(STRUCTURE))
def test_structure_op_shares_equal_curl_tpu(name):
    op, shape = STRUCTURE[name]
    _same_shares(op, op, shape, seed=len(name))


V, W = _rng.normal(size=(6,)), _rng.normal(size=(6,))
PRODUCTS = {
    "dot": (lambda a, b: a.dot(b), lambda a, b: a @ b),
    "dot-weights": (lambda a, b: a.dot(b, weights=np.arange(6.0) / 4), lambda a, b: a @ (
        b * np.arange(6.0) / 4)),
    "ger": (lambda a, b: a.ger(b), np.outer),
}


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_dot_ger_like_curl_tpu(name):
    fn, plain = PRODUCTS[name]
    out, counts = _port_counts(fn, V, W)
    np.testing.assert_allclose(out.get_plain_text(), plain(V, W), atol=0.05)
    assert counts == _curl_tpu_counts(fn, V, W)


P = np.linspace(0.1, 0.9, 256).reshape(16, 16)
SAMPLERS = {
    "dropout": lambda a: a.dropout(p=0.25),
    "bernoulli": lambda a: a.bernoulli(),
    "weighted_sample": lambda a: a.weighted_sample(dim=1)[0],
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_rounds_and_bytes_equal_curl_tpu(name):
    assert _port_counts(SAMPLERS[name], P)[1] == _curl_tpu_counts(SAMPLERS[name], P)


def test_dropout_bernoulli_weighted_sample_draws():
    """dropout keeps about 1 - p of the entries, scaled by 1 / (1 - p);
    bernoulli's mean follows p; weighted_sample picks one entry of each row."""
    ct.init(world_size=2, seed=8, device="cpu")
    x = ct.cryptensor(P)
    kept = x.dropout(p=0.25).get_plain_text()
    nz = kept != 0
    assert 0.65 < nz.mean() < 0.85
    np.testing.assert_allclose(kept[nz], P[nz] / 0.75, atol=0.01)
    np.testing.assert_allclose(x.dropout(p=0.25, training=False).get_plain_text(), P, atol=1e-4)
    bern = x.bernoulli().get_plain_text()
    assert set(np.unique(bern)) <= {0.0, 1.0}
    assert abs(bern.mean() - P.mean()) < 0.08
    sample, onehot = x.weighted_sample(dim=1)
    oh = onehot.get_plain_text()
    np.testing.assert_array_equal(oh.sum(1), np.ones(16))
    np.testing.assert_allclose(sample.get_plain_text(), (P * oh).sum(1), atol=0.01)


def test_randn_rounds_bytes_and_draws():
    """Box-Muller on private uniforms: curl_tpu's rounds and bytes; 255
    samples (an odd count) about N(0, 1)."""
    def fn(a):
        return type(a).randn(15, 17)

    ct.init(world_size=2, seed=9, device="cpu")
    ct.reset_communication_stats()
    z = ct.randn(15, 17).get_plain_text()
    stats = ct.get_communication_stats()
    curl_tpu.init(world_size=2, seed=1234)
    jcomm.reset_communication_stats()
    jax.make_jaxpr(lambda k: jrun(lambda: curl_tpu.mpc.MPCTensor.randn(15, 17), 2, k))(
        jax.random.PRNGKey(5))
    want = jcomm.get_communication_stats()
    assert (stats["rounds"], stats["bytes"]) == (want["rounds"], want["bytes"])
    assert z.shape == (15, 17) and np.isfinite(z).all()
    assert abs(z.mean()) < 0.25 and 0.75 < z.std() < 1.25
