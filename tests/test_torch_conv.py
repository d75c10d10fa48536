"""The port's ring convolutions and private convolutions against curl_tpu.

* ``curl_tpu_torch.ring``'s conv2d, conv1d, conv_transpose2d and
  conv_transpose1d (im2col columns through the ring matmul) equal
  ``curl_tpu.ring``'s (int8 limb planes through lax.conv_general_dilated)
  bit for bit mod 2^64, over the grids of tests/test_ring_matrix.py and the
  layouts a ResNet adds (the 7 x 7 stem at stride 2, 1 x 1 products at
  strides 1 and 2, batch 3 with 4 groups); ``conv_acc`` sums two
  convolutions of the Beaver layout (a weight share with the party axis,
  a public input without) as curl_tpu sums them party by party;
* the Beaver convolution protocols, plain and against a Beaver-masked
  kernel, a public kernel, and private matmul of a 1-D operand: decoded
  values within the reference's tolerances (tests/test_arithmetic.py's
  0.05) of float64 and of curl_tpu's decoded output on the same input,
  rounds and bytes equal curl_tpu's (its eager ops; a masked product
  through ``run_parties``, traced with ``jax.make_jaxpr`` for its counts);
* a convolution's triple recorded, filled and served by the tuple cache,
  and its request kept through the JSON request file.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import curl_tpu  # noqa: E402
from curl_tpu import comm as jcomm  # noqa: E402
from curl_tpu import ring as jring  # noqa: E402
from curl_tpu.mpc.primitives import beaver as jbeaver  # noqa: E402
from curl_tpu.mpc.mpc import MPCTensor as JMPCTensor  # noqa: E402
from curl_tpu.parallel import run_parties as jrun  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import ring as tring  # noqa: E402
from curl_tpu_torch.mpc.mpc import MPCTensor as TMPCTensor  # noqa: E402
from curl_tpu_torch.mpc.primitives import beaver as tbeaver  # noqa: E402


def ru64(rng, shape):
    return rng.integers(0, 2 ** 64, size=shape, dtype=np.uint64)


# (op, x shape, w shape, keyword arguments): tests/test_ring_matrix.py's
# grids, then a ResNet's layouts and an odd transposed one
RING_CASES = (
    [("conv2d", (2, 2 * g, 7, 6), (4, 2, 3, 3), dict(stride=s, padding=p, dilation=d, groups=g))
     for s, p, d, g in ((1, 0, 1, 1), (2, 1, 1, 1), (1, 2, 2, 1), (1, 1, 1, 2))]
    + [("conv1d", (2, 3, 11), (5, 3, 4), dict(stride=s, padding=p, dilation=d))
       for s, p, d in ((1, 0, 1), (2, 1, 1), (1, 1, 3))]
    + [("conv_transpose2d", (1, 3, 5, 4), (3, 2, 3, 3), dict(stride=s, padding=p,
                                                              output_padding=o))
       for s, p, o in ((1, 0, 0), (2, 1, 1), (3, 2, 0))]
    + [("conv_transpose1d", (2, 2, 9), (2, 3, 4), dict(stride=s, padding=p))
       for s, p in ((1, 0), (2, 1))]
    + [("conv2d", (1, 3, 20, 20), (8, 3, 7, 7), dict(stride=2, padding=3)),
       ("conv2d", (2, 6, 5, 5), (4, 6, 1, 1), {}),
       ("conv2d", (2, 6, 5, 5), (4, 6, 1, 1), dict(stride=2)),
       ("conv2d", (3, 8, 6, 6), (8, 2, 3, 3), dict(stride=2, padding=1, groups=4)),
       ("conv_transpose2d", (2, 2, 4, 3), (2, 3, 2, 3), dict(stride=2, padding=1,
                                                             output_padding=1, dilation=2))]
)
RING_IDS = [f"{op}-{i}" for i, (op, *_) in enumerate(RING_CASES)]


@pytest.mark.parametrize("op,xs,ws,kw", RING_CASES, ids=RING_IDS)
def test_ring_conv_equals_curl_tpu(op, xs, ws, kw):
    rng = np.random.default_rng(len(xs) * 131 + sum(xs) + sum(ws))
    x, w = ru64(rng, xs), ru64(rng, ws)
    want = np.asarray(getattr(jring, op)(x, w, **kw))
    got = tring.to_numpy_u64(getattr(tring, op)(tring.to_ring(x), tring.to_ring(w), **kw))
    np.testing.assert_array_equal(got, want)


def test_conv_acc_sums_the_beaver_layout_party_by_party():
    """eps (no party axis) against a (P, ...) weight share, plus a (P, ...)
    input share against a public delta: one conv_acc equals curl_tpu's two
    convolutions party by party."""
    rng = np.random.default_rng(7)
    kw = dict(stride=2, padding=1)
    eps, delta = ru64(rng, (2, 4, 6, 6)), ru64(rng, (5, 4, 3, 3))
    b_share, x_share = ru64(rng, (2, 5, 4, 3, 3)), ru64(rng, (2, 2, 4, 6, 6))
    got = tring.conv_acc("conv2d", [
        (tring.to_ring(eps), tring.to_ring(b_share)[:, None]),
        (tring.to_ring(x_share), tring.to_ring(delta))], **kw)
    for p in range(2):
        want = (np.asarray(jring.conv2d(eps, b_share[p], **kw))
                + np.asarray(jring.conv2d(x_share[p], delta, **kw)))
        np.testing.assert_array_equal(tring.to_numpy_u64(got[p]), want)


_rng = np.random.default_rng(2024)
X4 = _rng.normal(size=(2, 4, 6, 6))
W4 = _rng.normal(size=(6, 2, 3, 3)) * 0.5
X3 = _rng.normal(size=(2, 3, 9))
W3 = _rng.normal(size=(4, 3, 3)) * 0.5
WT4 = _rng.normal(size=(4, 3, 3, 3)) * 0.5
WT3 = _rng.normal(size=(3, 2, 4)) * 0.5
V5, M45, M53, T253 = (_rng.normal(size=s) for s in ((5,), (4, 5), (5, 3), (2, 5, 3)))
V5B = _rng.normal(size=(5,))
F = torch.nn.functional


def _t(a):
    return torch.tensor(a)


# name -> (x, y, op on encrypted operands, float64 op, masked, curl_tpu run
# on it): curl_tpu's eager ops compile per shape (about 7 s each on a CPU), so
# it runs on one case of each code path of its own; every case's counts are
# also held to the protocol's formula, which curl_tpu's meet
PROTOCOLS = {
    "conv2d": (X4, W4, lambda a, b: a.conv2d(b, stride=2, padding=1, groups=2),
               lambda a, b: F.conv2d(_t(a), _t(b), stride=2, padding=1, groups=2).numpy(),
               False, True),
    "conv2d-masked": (X4, W4, lambda a, b: a.conv2d(b, stride=2, padding=1, groups=2),
                      lambda a, b: F.conv2d(_t(a), _t(b), stride=2, padding=1,
                                            groups=2).numpy(), True, True),
    "conv1d": (X3, W3, lambda a, b: a.conv1d(b, stride=2, padding=1),
               lambda a, b: F.conv1d(_t(a), _t(b), stride=2, padding=1).numpy(), False, False),
    "conv_transpose2d": (X4, WT4, lambda a, b: a.conv_transpose2d(b, stride=2, padding=1,
                                                                  output_padding=1),
                         lambda a, b: F.conv_transpose2d(_t(a), _t(b), stride=2, padding=1,
                                                         output_padding=1).numpy(), False, True),
    "conv_transpose1d": (X3, WT3, lambda a, b: a.conv_transpose1d(b, stride=2),
                         lambda a, b: F.conv_transpose1d(_t(a), _t(b), stride=2).numpy(),
                         False, False),
    "matmul-1d-x": (V5, M53, lambda a, b: a.matmul(b), np.matmul, False, True),
    "matmul-1d-y": (M45, V5, lambda a, b: a.matmul(b), np.matmul, False, False),
    "matmul-1d-both": (V5, V5B, lambda a, b: a.matmul(b), np.matmul, False, False),
    "matmul-1d-batched": (V5, T253, lambda a, b: a.matmul(b), np.matmul, False, False),
    "matmul-1d-x-masked": (V5, M53, lambda a, b: a.matmul(b), np.matmul, True, True),
}


def _formula(name):
    """A product's rounds and bytes a party: one reveal of eps and delta (of
    delta first, alone, where the operand is masked) and the EGK truncation
    of the output."""
    x, y, _, plain, masked, _ = PROTOCOLS[name]
    n_out = np.asarray(plain(x, y)).size
    return 2 + masked, 8 * (x.size + y.size + n_out)


def _port_run(name):
    x, y, op, _, masked, _ = PROTOCOLS[name]
    ct.init(world_size=2, seed=1234, device="cpu")
    xe, ye = ct.cryptensor(x), ct.cryptensor(y)
    ct.reset_communication_stats()
    if masked:
        ye = TMPCTensor(tbeaver.mask_operand(ye._tensor))
    out = op(xe, ye)
    stats = ct.get_communication_stats()
    return out.get_plain_text(), (stats["rounds"], stats["bytes"])


def _curl_tpu_fn(name):
    _, _, op, _, masked, _ = PROTOCOLS[name]

    def fn(a, b):
        if masked:
            b = JMPCTensor(jbeaver.mask_operand(b._tensor))
        return op(a, b)

    return fn


@pytest.fixture(scope="module")
def curl_tpu_runs():
    """Each protocol's curl_tpu decoded output and its rounds and bytes:
    eager, or through run_parties (and traced for the counts) where the
    operand is masked inside the run."""
    out = {}
    curl_tpu.init(world_size=2, seed=1234)
    for name, (x, y, op, _, masked, run) in PROTOCOLS.items():
        if not run:
            continue
        if not masked:
            xe, ye = curl_tpu.cryptensor(x), curl_tpu.cryptensor(y)
            with curl_tpu.no_grad():
                jcomm.reset_communication_stats()
                decoded = op(xe, ye).get_plain_text()
                stats = jcomm.get_communication_stats()
            out[name] = np.asarray(decoded), (stats["rounds"], stats["bytes"])
            continue
        xe, ye = curl_tpu.cryptensor(x).mpc, curl_tpu.cryptensor(y).mpc
        fn = _curl_tpu_fn(name)
        jcomm.reset_communication_stats()
        jax.make_jaxpr(lambda k, a, b: jrun(fn, 2, k, a, b))(jax.random.PRNGKey(5), xe, ye)
        stats = jcomm.get_communication_stats()
        decoded = curl_tpu.CrypTensor(jrun(fn, 2, jax.random.PRNGKey(6), xe, ye)).get_plain_text()
        out[name] = np.asarray(decoded), (stats["rounds"], stats["bytes"])
    return out


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_private_product(name, curl_tpu_runs):
    x, y, _, plain, _, run = PROTOCOLS[name]
    got, counts = _port_run(name)
    ref = plain(x, y)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=0.05)
    assert counts == _formula(name)
    if run:
        want, want_counts = curl_tpu_runs[name]
        assert want.shape == ref.shape
        np.testing.assert_allclose(got, want, atol=0.05)
        assert counts == want_counts


def test_public_kernel_convolution():
    """A public kernel convolves every party's share at once; the product's
    rescale, no reveal of the input."""
    ct.init(world_size=2, seed=3, device="cpu")
    xe = ct.cryptensor(X4)
    ct.reset_communication_stats()
    got = xe.conv2d(W4, stride=2, padding=1, groups=2).get_plain_text()
    np.testing.assert_allclose(got, PROTOCOLS["conv2d"][3](X4, W4), atol=0.05)
    assert ct.get_communication_stats()["rounds"] == 1  # the EGK truncation


def test_conv_triple_traced_filled_and_served(tmp_path):
    """The dealer's conv triple goes through the tuple trace and cache like
    any other: recorded with its keyword arguments, kept through the JSON
    request file, generated by the fill (c = a * b by the ring convolution)
    and served to the same op, which then decodes as before."""
    from curl_tpu_torch.mpc.provider.provider import load_requests

    ct.init(world_size=2, seed=5, device="cpu")
    provider = ct.get_default_provider()
    provider.requests.clear()
    xe, we = ct.cryptensor(X4), ct.cryptensor(W4)
    ct.trace(True)
    xe.conv2d(we, stride=2, padding=1, groups=2)
    ct.trace(False)
    (req,) = [r for r in provider.requests if r.func == "generate_additive_triple"]
    assert req.args == ((2, 4, 6, 6), (6, 2, 3, 3), "conv2d")
    assert dict(req.kwargs) == dict(stride=2, padding=1, groups=2)
    path = str(tmp_path / "requests.json")
    provider.save_requests(path)
    assert load_requests(path) == provider.requests
    cache = ct.fill_cache()
    a, b, c = cache.entries[[r.func for r in provider.requests].index("generate_additive_triple")]
    np.testing.assert_array_equal(
        tring.to_numpy_u64(c.share.sum(0)),
        tring.to_numpy_u64(tring.conv2d(a.share.sum(0), b.share.sum(0), stride=2, padding=1,
                                        groups=2)))
    got = xe.conv2d(we, stride=2, padding=1, groups=2).get_plain_text()
    assert cache.cursor == len(cache.entries)
    provider.attach_cache(None)
    provider.requests.clear()
    np.testing.assert_allclose(got, PROTOCOLS["conv2d"][3](X4, W4), atol=0.05)
