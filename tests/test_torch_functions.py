"""The port's function library against curl_tpu: every function and method
of ``curl_tpu/functions/approximations.py``, ``power.py`` and ``logic.py``.

One table of cases (``chip_smoke.FUNCTION_CASES``, which phase 3d runs on
the card at (64, 3072)), each a (function, config override, input) on a
(4, 8) grid over the function's domain:

* the default-config functions (log, sqrt, sigmoid, tanh, erf, silu,
  relu) run eagerly in both packages: decoded values within
  tests/test_reference_parity.py's TOLS of each other and of the
  plaintext, equal rounds and bytes; and the port alone on the golden file
  of the original Curl's outputs (tests/golden/reference_outputs.npz),
  within TOLS over the interior samples, as test_reference_parity holds
  curl_tpu;
* every other method: rounds and bytes equal curl_tpu's, traced with
  ``jax.make_jaxpr`` through its ``run_parties`` (curl_tpu's eager runs of
  these take 0.3-15 s each); decoded values within twice curl_tpu's
  worst |error| at the same points over 64 draws (at least 0.01, below the
  midpoint of that worst and the function's range there) of float64 and
  of curl_tpu's decoded output on the same input at seed 1234, both read
  once eagerly into tests/golden/torch_function_reference.npz
  (``python3 tests/torch_function_reference.py outputs``);
* the faults of the reference (ROADMAP Queue C), which the port
  reproduces: the port is held to curl_tpu's decoded output, run eagerly,
  and the fault is pinned.

Every case that is not a fault also runs in the port on 2 of phase 3d's
64 rows, whose max and mean |error| must keep within the limits phase 3d
holds the card to (``function_tolerance``): the mean catches a wrong
method whose max error stays under curl_tpu's, such as a constant.

Then pow / pos_pow / polynomial / norm, drelu, hardtanh, the public
``where``, divmod / mod, and the crypten LUT truncation.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import curl_tpu  # noqa: E402
from curl_tpu import comm as jcomm  # noqa: E402
from curl_tpu.parallel import run_parties as jrun  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402

from chip_smoke import (FUNCTION_CASES, FUNCTION_FAULTS, FUNCTION_SHAPE,  # noqa: E402
                        FUNCTION_TOLS as TOLS, function_call, function_input,
                        function_plain, function_tolerance)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_outputs.npz")
# curl_tpu's decoded outputs of the cases it is not run on here
CURL_TPU_OUTPUTS = os.path.join(os.path.dirname(__file__), "golden",
                                "torch_function_reference.npz")
# the rows of phase 3d's input the port runs here
DENSE_ROWS = 2


def grid(lo, hi):
    return np.linspace(lo, hi, 32).reshape(4, 8)


def _input(key):
    """A case's (4, 8) grid over its domain (chip_smoke's phase 3d runs the
    same cases at (64, 3072))."""
    dom = FUNCTION_CASES[key][2]
    if dom == "normal":
        return np.random.default_rng(0).normal(size=(4, 8)) * 2
    if dom == "signed":
        return grid(2, 32) * np.where(np.arange(32).reshape(4, 8) % 2, -1.0, 1.0)
    x = grid(*dom)
    return x[:, :1] if key.endswith("-one") else x


# id -> (function, config override, input): chip_smoke.FUNCTION_CASES
CASES = {key: (fn, over, _input(key)) for key, (fn, over, _) in FUNCTION_CASES.items()}
FAULTS = FUNCTION_FAULTS


def _decoded(out):
    if isinstance(out, tuple):
        return np.stack([o.get_plain_text() for o in out])
    return out.get_plain_text()


def _curl_tpu_eager(key):
    _, over, x = CASES[key]
    curl_tpu.init(world_size=2, seed=1234)
    with curl_tpu.cfg.temp_override(over):
        xe = curl_tpu.cryptensor(x)
        jcomm.reset_communication_stats()
        out = function_call(xe, key)
        stats = jcomm.get_communication_stats()
    return _decoded(out), (stats["rounds"], stats["bytes"])


@pytest.fixture(scope="module")
def curl_tpu_runs():
    """Each case's (decoded, (rounds, bytes), limit on max |error|): eager
    for the defaults and the faults; for the rest, the decoded output and
    the limit from tests/golden/torch_function_reference.npz and a jaxpr
    trace."""
    out = {}
    outputs = np.load(CURL_TPU_OUTPUTS)
    for key in TOLS:
        out[key] = _curl_tpu_eager(key) + (TOLS[key],)
    for key, (tol, _) in FAULTS.items():
        if tol is not None:
            out[key] = _curl_tpu_eager(key) + (tol,)
    curl_tpu.init(world_size=2, seed=1234)
    key0 = jax.random.PRNGKey(5)
    for key, (_, over, x) in CASES.items():
        if key in out:
            continue
        xe = curl_tpu.cryptensor(x)
        with curl_tpu.cfg.temp_override(over):
            jcomm.reset_communication_stats()
            jax.make_jaxpr(lambda k, a: jrun(lambda v: function_call(v, key), 2, k, a))(
                key0, xe.mpc)
            stats = jcomm.get_communication_stats()
        out[key] = (outputs.get(key), (stats["rounds"], stats["bytes"]),
                    _limit(key, outputs))
    return out


def _limit(key, outputs):
    """Twice curl_tpu's worst |error| at the case's points over 64 draws,
    at least 0.01, below the midpoint of that worst and the function's
    range there (so that no constant passes)."""
    if key in FAULTS:
        return None
    worst = float(outputs[f"worst:{key}"])
    span = float(np.ptp(function_plain(key, CASES[key][2])))
    return min(max(2 * worst, 0.01), (worst + span) / 2)


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    ct.init(world_size=2, seed=1234, device="cpu")
    for key, (_, over, x) in CASES.items():
        with cfg.temp_override(over):
            xe = ct.cryptensor(x)
            ct.reset_communication_stats()
            res = function_call(xe, key)
            stats = ct.get_communication_stats()
        out[key] = (_decoded(res), (stats["rounds"], stats["bytes"]))
    return out


@pytest.mark.parametrize("key", sorted(CASES))
def test_function_method(key, port_runs, curl_tpu_runs):
    x = CASES[key][2]
    got, counts = port_runs[key]
    ref, ref_counts, tol = curl_tpu_runs[key]
    assert counts == ref_counts, f"{key}: rounds, bytes {counts} != curl_tpu's {ref_counts}"
    assert got.shape == function_plain(key, x).shape
    if key in FAULTS:
        tol, pin = FAULTS[key]
        assert pin(x, got), f"{key}: the reference's fault is not reproduced"
        if tol is not None:
            assert pin(x, ref), f"{key}: curl_tpu no longer shows the fault"
            np.testing.assert_allclose(got, ref, atol=tol, rtol=0.01)
        return
    err = np.abs(got - function_plain(key, x)).max()
    assert err <= tol, f"{key}: max |error| {err} > {tol}"
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=f"{key} against curl_tpu")


@pytest.mark.parametrize("key", sorted(k for k in CASES if k not in FAULTS))
def test_function_on_phase_3d_grid(key):
    """The port's max and mean |error| on DENSE_ROWS rows of phase 3d's
    input within the limits phase 3d holds the card to, which come from
    curl_tpu's readings on the whole input."""
    x = function_input(key, (DENSE_ROWS,) + FUNCTION_SHAPE[1:])
    ct.init(world_size=2, seed=1234, device="cpu")
    with cfg.temp_override(FUNCTION_CASES[key][1]):
        got = _decoded(function_call(ct.cryptensor(x), key))
    diff = np.abs(got - function_plain(key, x))
    tol, mean_tol = function_tolerance(key)
    assert diff.max() <= tol, f"{key}: max |error| {diff.max()} > {tol}"
    assert diff.mean() <= mean_tol, f"{key}: mean |error| {diff.mean()} > {mean_tol}"


def test_erf_taylor_is_the_reference_series(port_runs):
    """erf's Taylor method: the series the reference computes, with its
    pow's odd exponents (x^3)^((p - 1) / 2) and its multipliers encoded at
    16 fractional bits (those below 2^-16 vanish), in float64."""
    x = CASES["erf-Taylor"][2]

    def pow_ref(v, p):
        if p <= 2:
            return v ** p
        if p % 2 == 0:
            return pow_ref(v * v, p // 2)
        return pow_ref(v ** 3, (p - 1) // 2)

    def encoded(c):  # a public multiplier at 16 fractional bits, truncated
        return math.trunc(c * 2 ** 16) / 2 ** 16

    series = x.copy()
    for n in range(1, cfg.functions.erf_iterations + 1):
        c = encoded((-1) ** n / (math.factorial(n) * (2 * n + 1)))
        series = series + c * pow_ref(x, 2 * n + 1)
    series *= encoded(2 / math.sqrt(math.pi))
    np.testing.assert_allclose(port_runs["erf-Taylor"][0], series, rtol=0.01, atol=0.05)


# A Beaver square's output shares (two parties, 32 fractional bits) from a
# private GPT-Neo forward at width 192 on the CPU (block 20's attention
# softmax, the 7th squaring of exp's chain): they share 0.6945, but their
# signed sum overflows int64
WRAPPED_SQUARE = (-9223372034954432620, -9223372035772102307)


def test_square_local_truncation_wraps_like_curl_tpu():
    """A square's rescale in 2PC is local (crypten): each party shifts its
    own share, in both packages and in the fused kernel's plain version. A
    pair of shares whose signed sum overflows int64 comes out 2^48 off,
    -2^32 + x^2 decoded; for shares drawn uniformly that happens with
    probability about x^2 2^32 / 2^64 an element (ROADMAP Queue C)."""
    import jax.numpy as jnp

    from curl_tpu import ring as jring
    from curl_tpu_torch import ring as tring
    from curl_tpu_torch.kernels import fused_mul

    value = (sum(WRAPPED_SQUARE) % 2 ** 64) / 2 ** 32
    shares = torch.tensor(WRAPPED_SQUARE, dtype=torch.int64)

    def decoded(pair):
        return (sum(int(v) for v in pair) + 2 ** 63) % 2 ** 64 - 2 ** 63

    port = decoded(tring.trunc_div_signed(shares, 2 ** 16)) / 2 ** 16
    fused = decoded(fused_mul.trunc_div_pow2(shares, 16)) / 2 ** 16
    ref_shares = jnp.asarray([v % 2 ** 64 for v in WRAPPED_SQUARE], dtype=jnp.uint64)
    ref = decoded(np.asarray(jring.to_signed(jring.trunc_div_signed(ref_shares, 2 ** 16)))) / 2 ** 16
    assert port == fused == ref
    assert abs(port - (value - 2 ** 32)) < 2 ** -15


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="golden file missing")
@pytest.mark.parametrize("name", sorted(TOLS))
def test_default_functions_golden(name):
    """The port on the original Curl's golden grid, as
    tests/test_reference_parity.py holds curl_tpu."""
    data = np.load(GOLDEN, allow_pickle=True)
    names = [str(n) for n in data["_names"]]
    lo, hi = data["_inputs"][names.index(name)]
    xs = np.linspace(lo, hi, int(data["_n"][0]))
    ct.init(world_size=2, seed=1234, device="cpu")
    got = getattr(ct.cryptensor(xs), name)().get_plain_text()
    err = np.abs(got - data[name])[2:-2]
    assert err.max() <= TOLS[name], f"{name}: {err.max()} > {TOLS[name]}"


# -- power, logic, divmod -----------------------------------------------------

POW_X = grid(-2, 2)


def _port_counts(op, *inputs, precision=None):
    ct.init(world_size=2, seed=1234, device="cpu")
    enc = [ct.cryptensor(v, precision=precision) for v in inputs]
    ct.reset_communication_stats()
    out = op(*enc)
    stats = ct.get_communication_stats()
    return out, (stats["rounds"], stats["bytes"])


def _curl_tpu_counts(op, *inputs, precision=None):
    curl_tpu.init(world_size=2, seed=1234)
    enc = [curl_tpu.cryptensor(v, precision=precision).mpc for v in inputs]
    jcomm.reset_communication_stats()
    jax.make_jaxpr(lambda k, *a: jrun(op, 2, k, *a))(jax.random.PRNGKey(5), *enc)
    stats = jcomm.get_communication_stats()
    return stats["rounds"], stats["bytes"]


COND = (grid(-1, 1) > 0).astype(np.float64)
OPS = {
    # tests/test_mpc_sweep.py's tolerances
    "pow0": (lambda a: a.pow(0), lambda v: np.ones_like(v), 0.01, (POW_X,)),
    "pow1": (lambda a: a.pow(1), lambda v: v, 0.01, (POW_X,)),
    "pow2": (lambda a: a.pow(2), lambda v: v ** 2, 0.05, (POW_X,)),
    "pow3": (lambda a: a.pow(3), lambda v: v ** 3, 0.12, (POW_X,)),
    "pow-1": (lambda a: a.pow(-1), lambda v: 1 / v, 0.05, (grid(2, 32),)),
    # exp(1.5 log x) over log's tested domain (tests/test_functions.py), with
    # exp's tolerance, rtol 0.05 (tests/test_mpc_sweep.py)
    "pos_pow1.5": (lambda a: a.pos_pow(1.5), lambda v: v ** 1.5, (0.01, 0.05), (grid(2, 8),)),
    "polynomial": (lambda a: a.polynomial([0.5, -0.25, 0.125]),
                   lambda v: 0.5 * v - 0.25 * v ** 2 + 0.125 * v ** 3, 0.1, (POW_X,)),
    "norm": (lambda a: a.norm(), lambda v: np.linalg.norm(v), 0.1, (POW_X,)),
    "norm1-dim": (lambda a: a.norm(p=1, dim=1), lambda v: np.abs(v).sum(1), 0.05, (POW_X,)),
    "drelu": (lambda a: a.drelu(), lambda v: (v >= 0) * 1.0, 0.01, (POW_X,)),
    "hardtanh": (lambda a: a.hardtanh(), lambda v: np.clip(v, -1, 1), 0.01, (POW_X,)),
    "hardtanh-2.5-0.5": (lambda a: a.hardtanh(-2.5, 0.5), lambda v: np.clip(v, -2.5, 0.5), 0.01,
                         (POW_X,)),
    "where-public": (lambda a, b: a.where(COND, b), lambda v, w: np.where(COND > 0.5, v, w),
                     0.02, (POW_X, grid(3, 5))),
    "where-public-y": (lambda a: a.where(COND, 2.5), lambda v: np.where(COND > 0.5, v, 2.5),
                       0.02, (POW_X,)),
    "where-private": (lambda a, c, b: a.where(c, b), lambda v, c, w: np.where(c > 0.5, v, w),
                      0.02, (POW_X, COND, grid(3, 5))),
    "rsub": (lambda a: 1.5 - a, lambda v: 1.5 - v, 1e-4, (POW_X,)),
    "rtruediv": (lambda a: 2.0 / a, lambda v: 2.0 / v, 0.1, (grid(2, 32),)),
    # the local truncation errs by one unit of the quotient, the remainder
    # by one divisor
    "divmod": (lambda a: a.divmod(2 ** 4)[0], lambda v: np.floor(v * 2 ** 12) / 2 ** 16, 1e-4,
               (POW_X,)),
    "mod": (lambda a: a.mod(2 ** 4), lambda v: np.mod(v, 2 ** -12), 5e-4, (POW_X,)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_power_logic_divmod(name):
    op, plain, tol, inputs = OPS[name]
    out, counts = _port_counts(op, *inputs)
    assert counts == _curl_tpu_counts(op, *inputs), name
    atol, rtol = tol if isinstance(tol, tuple) else (tol, 0)
    np.testing.assert_allclose(out.get_plain_text(), plain(*inputs), atol=atol, rtol=rtol)


def test_pow_odd_exponent_is_the_reference():
    """pow(5) computes (x^3)^2, as curl_tpu's pow does (ROADMAP Queue C)."""
    ct.init(world_size=2, seed=1234, device="cpu")
    got = ct.cryptensor(grid(-1.5, 1.5)).pow(5).get_plain_text()
    np.testing.assert_allclose(got, grid(-1.5, 1.5) ** 6, atol=0.1)


def test_divmod_reassembles():
    """divmod's quotient times the divisor plus the remainder is the input's
    encoding exactly (ring arithmetic, no randomness)."""
    ct.init(world_size=2, seed=1234, device="cpu")
    x = ct.cryptensor(POW_X)
    d, r = x.divmod(2 ** 10)
    assert np.array_equal(((d.share * 2 ** 10) + r.share).sum(0).numpy(), x.share.sum(0).numpy())


def test_nothing_refused():
    """No method of curl_tpu's function library is refused by the port."""
    import inspect

    from curl_tpu_torch.functions import approximations, logic, power

    for mod in (approximations, logic, power):
        assert "NotImplementedError" not in inspect.getsource(mod), mod.__name__
