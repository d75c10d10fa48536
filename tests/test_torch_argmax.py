"""The port's private equality, argmax and causal softmax against
curl_tpu's, on the CPU: ``eq`` and ``ne`` at 2 and 3 parties, argmax /
argmin / min by each ported max method, the masked softmax and
``Attention(causal=True)``, the pieces of the decode loop of
``models/generate.py`` (tests/test_torch_generate.py).

curl_tpu's eager protocols cost seconds to a minute each on a CPU (its
masked softmax about 30 s, a causal attention about 55 s, its argmax
20-30 s), so its rounds and bytes are counted at trace (``jax.make_jaxpr``,
parameters as zero shares of the right shapes), and its decoded values are
run eagerly only for equality; the other values are held to the plaintext, which the
exact comparisons reproduce. curl_tpu counts a ``lax.scan`` body once
whatever its trip count (ROADMAP Queue C); where its scan_reduction runs
one, the port's count is curl_tpu's plus the steps after the first.
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
from curl_tpu import nn as jnn  # noqa: E402
from curl_tpu.config import cfg as jcfg  # noqa: E402
from curl_tpu.mpc.mpc import MPCTensor as JMPCTensor  # noqa: E402
from curl_tpu.parallel import compile_parties as jcompile  # noqa: E402


import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.functions.maximum import _tournament_select  # noqa: E402

_g = np.random.default_rng(11)
X = _g.normal(size=(3, 8)) * 2
Y = X.copy()
Y[:, ::2] += 0.5
SCORES = _g.normal(size=(2, 4, 4)) * 2
MASK = np.tril(np.ones((4, 4)))
# tests/test_reference_parity.py TOLS["softmax"]
SOFTMAX_TOL = 0.04


def _zero_shares(tree):
    """A plaintext parameter pytree as MPCTensors of zero shares (2
    parties): what curl_tpu's trace needs, without its eager encryption."""
    return jax.tree_util.tree_map(
        lambda p: JMPCTensor.from_shares(jnp.zeros((2,) + tuple(np.shape(p)), jnp.uint64)), tree)


def _jax_counts(fn, ws, *args):
    """curl_tpu's rounds, bytes and calls of ``fn`` on MPCTensor
    arguments, counted at trace."""
    jcomm.reset_communication_stats()
    jax.make_jaxpr(jcompile(fn, ws))(jax.random.PRNGKey(5), *args)
    s = jcomm.get_communication_stats()
    return s["rounds"], s["bytes"], dict(s["calls"])


def _port_run(fn, ws, *values):
    ct.init(world_size=ws, seed=1234, device="cpu")
    enc = [ct.cryptensor(v) for v in values]
    ct.reset_communication_stats()
    out = fn(*enc)
    s = ct.get_communication_stats()
    return out, (s["rounds"], s["bytes"], s["calls"])


def _jax_enc(ws, *values):
    curl_tpu.init(world_size=ws, seed=1234)
    return [curl_tpu.cryptensor(v).mpc for v in values]


# -- equality -----------------------------------------------------------------

@pytest.mark.parametrize("ws", [2, 3])
@pytest.mark.parametrize("op", ["eq", "ne"])
def test_eq_ne_decode_and_count_like_curl_tpu(op, ws):
    fn = (lambda a, b: a.eq(b)) if op == "eq" else (lambda a, b: a.ne(b))
    out, counted = _port_run(fn, ws, X, Y)
    want = (X == Y) if op == "eq" else (X != Y)
    np.testing.assert_array_equal(out.get_plain_text(), want.astype(np.float64))
    assert counted == _jax_counts(fn, ws, *_jax_enc(ws, X, Y))


def test_eq_decodes_like_curl_tpu_eagerly():
    curl_tpu.init(world_size=2, seed=3)
    want = curl_tpu.cryptensor(X).eq(curl_tpu.cryptensor(Y)).get_plain_text()
    out, _ = _port_run(lambda u, v: u.eq(v), 2, X, Y)
    np.testing.assert_array_equal(out.get_plain_text(), want)


def test_eq_with_64_bit_words():
    with cfg.temp_override({"mpc.compare_bits": 64}):
        out, counted = _port_run(lambda a, b: a.eq(b), 2, X, Y)
    np.testing.assert_array_equal(out.get_plain_text(), (X == Y).astype(np.float64))
    with jcfg.temp_override({"mpc.compare_bits": 64}):
        assert counted == _jax_counts(lambda a, b: a.eq(b), 2, *_jax_enc(2, X, Y))


# -- argmax / argmin / min ----------------------------------------------------

OPS = {
    "argmax": (lambda a: a.argmax(dim=-1), lambda x: np.eye(8)[x.argmax(-1)], 0.0),
    "argmin": (lambda a: a.argmin(dim=-1), lambda x: np.eye(8)[x.argmin(-1)], 0.0),
    "min": (lambda a: a.min(dim=-1)[0], lambda x: x.min(-1), 2.0 ** -15),
}


def _scan_step_counts(shape):
    """The port's CommStats of one scan_reduction tournament step."""
    ct.init(world_size=2, seed=0, device="cpu")
    c = ct.cryptensor(np.zeros(shape))
    ct.reset_communication_stats()
    _tournament_select(c, c, False)
    s = ct.get_communication_stats()
    return s["rounds"], s["bytes"], s["calls"]


@pytest.mark.parametrize("method", ["pairwise", "log_reduction", "scan_reduction",
                                    "double_log_reduction", "accelerated_cascade"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_argmax_argmin_min_by_method_like_curl_tpu(op, method):
    fn, plain, tol = OPS[op]
    with cfg.temp_override({"functions.max_method": method}):
        out, counted = _port_run(fn, 2, X)
    np.testing.assert_allclose(out.get_plain_text(), plain(X), atol=tol)
    with jcfg.temp_override({"functions.max_method": method}):
        want = _jax_counts(fn, 2, *_jax_enc(2, X))
    if method == "scan_reduction":
        # the 8 lanes' butterfly: 3 steps, one counted by curl_tpu
        r, b, calls = _scan_step_counts(X.shape)
        want = (want[0] + 2 * r, want[1] + 2 * b,
                {k: n + 2 * calls.get(k, 0) for k, n in want[2].items()})
    assert counted == want


@pytest.mark.parametrize("method", ["log_reduction", "scan_reduction"])
def test_argmax_indices_ties_and_all_elements(method):
    """one_hot=False gives the index; dim=None reduces every element; a
    tie picks exactly one of the tied lanes."""
    tied = np.array([[1.0, 3.0, 3.0, -1.0], [2.0, 2.0, 2.0, 2.0]])
    with cfg.temp_override({"functions.max_method": method}):
        idx, _ = _port_run(lambda a: a.argmax(dim=1, one_hot=False), 2, X)
        flat, _ = _port_run(lambda a: a.argmax(), 2, X)
        top, _ = _port_run(lambda a: a.max(), 2, X)
        oh, _ = _port_run(lambda a: a.argmax(dim=-1), 2, tied)
    np.testing.assert_allclose(idx.get_plain_text(), X.argmax(1), atol=1e-6)
    np.testing.assert_array_equal(flat.get_plain_text(), np.eye(X.size)[X.argmax()].reshape(X.shape))
    np.testing.assert_allclose(top.get_plain_text(), X.max(), atol=2.0 ** -15)
    got = oh.get_plain_text()
    np.testing.assert_array_equal(got.sum(-1), [1.0, 1.0])
    assert got[0, 1] + got[0, 2] == 1.0


def test_later_max_methods_raise():
    """The two methods that raised until their port (ROADMAP A10b) now run:
    each gives the argmax one-hot, and the max of every element."""
    ct.init(world_size=2, seed=0, device="cpu")
    x = ct.cryptensor(X)
    for method in ("double_log_reduction", "accelerated_cascade"):
        with cfg.temp_override({"functions.max_method": method}):
            np.testing.assert_array_equal(x.argmax(dim=-1).get_plain_text(),
                                          np.eye(X.shape[1])[X.argmax(-1)])
            np.testing.assert_allclose(x.max().get_plain_text(), X.max(), atol=2.0 ** -15)


# -- the masked softmax and causal attention -----------------------------------

def test_masked_softmax_like_curl_tpu():
    out, counted = _port_run(lambda a: a.softmax(-1, mask=MASK), 2, SCORES)
    e = np.exp(SCORES - np.where(MASK > 0, SCORES, -np.inf).max(-1, keepdims=True)) * MASK
    np.testing.assert_allclose(out.get_plain_text(), e / e.sum(-1, keepdims=True),
                               atol=SOFTMAX_TOL)
    assert np.all(out.get_plain_text()[..., MASK == 0] == 0)
    assert counted == _jax_counts(lambda a: a.softmax(-1, mask=MASK), 2, *_jax_enc(2, SCORES))


def test_causal_attention_like_curl_tpu():
    curl_tpu.init(world_size=2, seed=3)
    jatt = jnn.Attention(8, 2, causal=True)
    sd = {k: np.asarray(v) for k, v in jatt.state_dict().items()}
    x = np.random.default_rng(1).normal(size=(1, 4, 8))
    apply_fn, params = jatt.functional()
    want = _jax_counts(apply_fn, 2, _zero_shares(params), *_jax_enc(2, x))

    ct.init(world_size=2, seed=3, device="cpu")
    att = ct.nn.Attention(8, 2, causal=True)
    for key, value in sd.items():
        mod, name = key.rsplit(".", 1)
        getattr(att, mod)._params[name] = torch.from_numpy(value.copy())
    att.encrypt(src=0)
    xe = ct.cryptensor(x)
    ct.reset_communication_stats()
    got = att(xe).get_plain_text()
    s = ct.get_communication_stats()
    assert (s["rounds"], s["bytes"], s["calls"]) == want

    def lin(v, p):
        return v @ sd[p + ".weight"].T + sd[p + ".bias"]

    q, k, v = (z.reshape(1, 4, 2, 4).transpose(0, 2, 1, 3)
               for z in np.split(lin(x, "search"), 3, axis=-1))
    a = np.exp(q @ k.transpose(0, 1, 3, 2) / 2.0) * np.tril(np.ones((4, 4)))
    y = (a / a.sum(-1, keepdims=True)) @ v
    np.testing.assert_allclose(got, lin(y.transpose(0, 2, 1, 3).reshape(1, 4, 8), "proj"),
                               atol=0.05)
