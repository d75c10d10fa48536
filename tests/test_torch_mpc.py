"""The port's protocols and functions against curl_tpu, on the same inputs.

Each case encrypts the same numpy inputs in both packages and runs the same
operation. Randomness differs between the packages (Philox against
threefry), so decoded values are compared: with the plaintext, within
curl_tpu's own test tolerance for that function (tests/test_functions.py,
test_arithmetic.py, test_nn.py), and with curl_tpu's decoded output, within
the cross-framework tolerance of tests/test_reference_parity.py (one LUT
cell of EGK rounding) where the function reads a table. The rounds, bytes
and collective calls of each operation must equal curl_tpu's exactly. The
wavelet tables and the circuit masks are compared bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import curl_tpu
from curl_tpu import comm as jcomm
from curl_tpu import nn as jnn
from curl_tpu.functions.luts import LookupTables as JLookupTables
from curl_tpu.mpc.primitives import circuit as jcircuit

import curl_tpu_torch as ct
from curl_tpu_torch import nn as tnn
from curl_tpu_torch.functions.luts import LookupTables as TLookupTables
from curl_tpu_torch.mpc.primitives import circuit as tcircuit

_rng = np.random.default_rng(2024)
X = _rng.normal(size=(4, 8)) * 2
Y = _rng.normal(size=(4, 8)) * 2
W = _rng.normal(size=(8, 3))
# every input is (4, 8): the reference's eager ops compile once per shape
POS_RECIP = np.linspace(2.0, 32.0, 32).reshape(4, 8)
POS_ISQRT = np.linspace(2.0, 200.0, 32).reshape(4, 8)
EXP_X = np.linspace(-3.0, 3.0, 32).reshape(4, 8)
GELU_X = np.linspace(-3.0, 3.0, 32).reshape(4, 8)
# tests/test_nn.py::test_layernorm_module's input and module width
LN_X = np.random.default_rng(2024).normal(size=(2, 6)) * 3


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _layernorm(x):
    return (x - x.mean(-1, keepdims=True)) / np.sqrt(x.var(-1, keepdims=True) + 1e-5)


def _gelu(x):
    return x * (1 + np.vectorize(math.erf)(x / math.sqrt(2))) / 2


def _ln_module(pkg_nn):
    m = pkg_nn.LayerNorm(6)
    m.encrypt(src=0)
    return m


# name -> (inputs, op on encrypted inputs given the package's nn, plaintext,
#          tolerance vs plaintext, tolerance vs curl_tpu)
CASES = {
    "mul": ((X, Y), lambda nn, a, b: a * b, lambda a, b: a * b, 1e-2, 1e-2),
    "matmul": ((X, W), lambda nn, a, b: a.matmul(b), lambda a, b: a @ b, 0.05, 0.05),
    "square": ((X,), lambda nn, a: a.square(), lambda a: a * a, 1e-2, 1e-2),
    "egk_trunc_pr": ((np.abs(X) * 100,), lambda nn, a: a.egk_trunc_pr(62, 8),
                     lambda a: a / 256, 0.02, 0.02),
    "ltz": ((X,), lambda nn, a: a._ltz(), lambda a: (a < 0) * 1.0, 1e-6, 1e-6),
    "lt": ((X, Y), lambda nn, a, b: a.lt(b), lambda a, b: (a < b) * 1.0, 1e-6, 1e-6),
    "max_value": ((X,), lambda nn, a: a.max_value(-1, keepdim=True),
                  lambda a: a.max(-1, keepdims=True), 0.01, 0.01),
    "exp": ((EXP_X,), lambda nn, a: a.exp(), np.exp, None, 0.05),
    "reciprocal": ((POS_RECIP,), lambda nn, a: a.reciprocal(), lambda a: 1 / a, 0.05, 0.05),
    "inv_sqrt": ((POS_ISQRT,), lambda nn, a: a.inv_sqrt(), lambda a: 1 / np.sqrt(a), 0.08, 0.05),
    "gelu": ((GELU_X,), lambda nn, a: a.gelu(), _gelu, 0.05, 0.06),
    "softmax": ((X,), lambda nn, a: a.softmax(-1), _softmax, 0.2, 0.04),
    "layernorm": ((LN_X,), lambda nn, a: _ln_module(nn)(a), _layernorm, 0.12, 0.12),
}


# cases also run with three parties (wrap-corrected truncation, 3-way A2B)
RUNS = [(name, 2) for name in sorted(CASES)] + [(name, 3) for name in ("ltz", "mul", "square")]
RUN_IDS = [f"{name}-{ws}pc" for name, ws in RUNS]


def _run_curl_tpu(name, ws):
    inputs, op, *_ = CASES[name]
    curl_tpu.init(world_size=ws, seed=1234)
    enc = [curl_tpu.cryptensor(v) for v in inputs]
    with curl_tpu.no_grad():
        jcomm.reset_communication_stats()
        out = op(jnn, *enc)
        stats = jcomm.get_communication_stats()
    return out.get_plain_text(), stats


def _run_port(name, ws):
    inputs, op, *_ = CASES[name]
    ct.init(world_size=ws, seed=1234, device="cpu")
    enc = [ct.cryptensor(v) for v in inputs]
    ct.reset_communication_stats()
    out = op(tnn, *enc)
    return out.get_plain_text(), ct.get_communication_stats()


@pytest.fixture(scope="module")
def results():
    cache = {}

    def get(name, ws):
        if (name, ws) not in cache:
            cache[name, ws] = (_run_port(name, ws), _run_curl_tpu(name, ws))
        return cache[name, ws]

    return get


@pytest.mark.parametrize("name,ws", RUNS, ids=RUN_IDS)
def test_decoded_matches_plaintext(results, name, ws):
    inputs, _, plain, tol, _ = CASES[name]
    (got, _), _ = results(name, ws)
    want = plain(*inputs)
    assert got.shape == want.shape
    if name == "exp":  # limit method: relative error ~ x^2 / 2^9
        np.testing.assert_allclose(got, want, rtol=0.03, atol=0.01)
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("name,ws", RUNS, ids=RUN_IDS)
def test_decoded_matches_curl_tpu(results, name, ws):
    tol = CASES[name][4]
    (got, _), (want, _) = results(name, ws)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("name,ws", RUNS, ids=RUN_IDS)
def test_rounds_and_bytes_equal_curl_tpu(results, name, ws):
    (_, got), (_, want) = results(name, ws)
    assert got == want


def test_lookup_tables_bit_equal():
    ct.init(world_size=2, seed=0, device="cpu")
    theirs = JLookupTables().LUTs
    ours = TLookupTables().LUTs
    assert sorted(ours.names()) == sorted(theirs)
    for name in theirs:
        np.testing.assert_array_equal(ours[name], np.asarray(theirs[name]), err_msg=name)


def test_circuit_masks_equal():
    assert [np.uint64(np.int64(m).view(np.uint64)) for m in tcircuit._MASKS] == list(jcircuit._MASKS)
    assert tcircuit._MASKS_U == jcircuit._level_masks()
    for ours, theirs in ((tcircuit._MULTIPLIERS, jcircuit._MULTIPLIERS),
                         (tcircuit._OUT_MASKS, jcircuit._OUT_MASKS)):
        assert [np.int64(v).view(np.uint64) for v in ours] == list(theirs)
    for w in (16, 32, 64):
        assert np.int64(tcircuit._boundary_clear(w)).view(np.uint64) == jcircuit._boundary_clear(w)


def test_public_operands_and_broadcasting():
    """Public operands and per-party broadcasting keep the party axis apart
    (a (768,) weight against a (1, 64, 768) activation in the model)."""
    ct.init(world_size=2, seed=3, device="cpu")
    a = _rng.normal(size=(2, 3, 4))
    b = _rng.normal(size=(4,))
    ea, eb = ct.cryptensor(a), ct.cryptensor(b)
    np.testing.assert_allclose((ea * eb).get_plain_text(), a * b, atol=1e-2)
    np.testing.assert_allclose((eb * ea).get_plain_text(), a * b, atol=1e-2)
    np.testing.assert_allclose((ea + eb).get_plain_text(), a + b, atol=1e-4)
    np.testing.assert_allclose((ea - 1.5).get_plain_text(), a - 1.5, atol=1e-4)
    np.testing.assert_allclose((ea * b).get_plain_text(), a * b, atol=1e-2)
    np.testing.assert_allclose((ea + torch.from_numpy(b)).get_plain_text(), a + b, atol=1e-4)
    w = _rng.normal(size=(4, 5))
    np.testing.assert_allclose(ea.matmul(w).get_plain_text(), a @ w, atol=0.05)
    np.testing.assert_allclose(ea.matmul(ct.cryptensor(w)).get_plain_text(), a @ w, atol=0.05)


def test_lut_and_embedding_lookups():
    """The gather-form LUT and the rotated-one-hot embedding look up the
    secret index, each with one reveal (plus the Beaver matmul's)."""
    ct.init(world_size=2, seed=4, device="cpu")
    idx = ct.cryptensor(np.array([[0.0, 5.0, 31.0, 7.0]]), precision=0)
    lut = np.arange(32, dtype=np.int64) * 3 - 40
    table = _rng.normal(size=(32, 3))
    etable = ct.cryptensor(table)
    ct.reset_communication_stats()
    looked_up = idx.evaluate_lut(lut).share.sum(0)
    assert ct.get_communication_stats()["rounds"] == 1
    np.testing.assert_array_equal(looked_up.numpy()[0], lut[[0, 5, 31, 7]])
    ct.reset_communication_stats()
    embedded = idx.evaluate_embed(etable)
    assert ct.get_communication_stats()["rounds"] == 2
    np.testing.assert_allclose(embedded.get_plain_text()[0], table[[0, 5, 31, 7]], atol=1e-4)


def test_inv_sqrt_just_below_one_wraps_like_curl_tpu():
    """The reference's tailored-haar inv_sqrt indexes table 0 (4096 cells
    over [0, 1)) by a probabilistic 4-bit truncation; just below 1.0 the
    index can round up to 4096 and wrap to cell 0, giving table 0's first
    value instead of about 1 (ROADMAP, Queue C). The port selects table 0
    by that same index, so where it rounds up it reads table 1 (cell
    [1, 2): 0.828) and never wraps; the rounds and bytes stay curl_tpu's."""
    x = np.full((4, 8), 1 - 2.0 ** -14)
    curl_tpu.init(world_size=2, seed=3)
    with curl_tpu.no_grad():
        jcomm.reset_communication_stats()
        theirs = np.asarray(curl_tpu.cryptensor(x).inv_sqrt().get_plain_text())
        their_stats = jcomm.get_communication_stats()
    ct.init(world_size=2, seed=3, device="cpu")
    xe = ct.cryptensor(x)
    ct.reset_communication_stats()
    ours = xe.inv_sqrt().get_plain_text()
    our_stats = ct.get_communication_stats()
    table0_first = TLookupTables().LUTs["inv_sqrt_tailored_haar_0"][0] / 2.0 ** 16
    wrapped = np.isclose(theirs, table0_first, rtol=1e-3)
    assert wrapped.mean() > 0.5
    assert np.all(wrapped | np.isclose(theirs, 1.0, atol=0.01))
    assert not np.isclose(ours, table0_first, rtol=1e-3).any()
    assert np.all(np.isclose(ours, 1.0, atol=0.01) | np.isclose(ours, 0.828, atol=0.01))
    assert (our_stats["rounds"], our_stats["bytes"]) == (their_stats["rounds"],
                                                         their_stats["bytes"])
