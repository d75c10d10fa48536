"""The port's autograd and gradient library against curl_tpu.

One case per name in curl_tpu's ``FUNCTION_REGISTRY`` (74 registered
functions and the ``__getitem__`` alias), the inputs and tolerances of
``tests/test_gradients_sweep.py``: the same inputs, drawn from a numpy
seed, go through the port's forward and ``backward`` and through
curl_tpu's, and the port's decoded output and input gradients must lie
within curl_tpu's own tolerances of curl_tpu's, its rounds and bytes over
the forward and the backward equal curl_tpu's. Where a case draws private
randomness (dropout) the two packages' masks differ, so the port's output
and gradient are held to its own mask, as curl_tpu's sweep holds curl_tpu.

curl_tpu's eager autograd takes seconds to minutes a case on a CPU, so its
readings are read from ``tests/golden/torch_autograd_reference.npz``,
written by ``tests/torch_train_reference.py autograd`` from this file's
``CASES``.

The port's readings are also held to float64 torch within the same
tolerances (curl_tpu's own bar), and to curl_tpu's within twice them. Also
here: curl_tpu's gradient faults (ROADMAP Queue C), pinned on probes of
their own, and the max pool's backward scatter against float64 at
overlapping and padded windows.
"""

import os
import sys
import zlib
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import autograd  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_autograd_reference.npz")
F = torch.nn.functional


@dataclass
class Run:
    """One forward and backward: the inputs (each encrypted, the ones in
    ``grad`` requiring grad), the op, curl_tpu's sweep tolerances on the
    output and the gradients, how the backward starts: ``sum``
    (out.sum().backward()) or ``self`` (a scalar's out.backward()), and the
    op in float64 torch (``plain``) where the case has no private
    randomness."""

    arrays: list
    fn: object
    tol: float = 0.02
    grad_tol: float = None
    backward: str = "sum"
    grad: list = field(default=None)
    random: bool = False
    plain: object = None

    def __post_init__(self):
        if self.grad_tol is None:
            self.grad_tol = self.tol
        if self.grad is None:
            self.grad = [True] * len(self.arrays)


class Lib:
    """Either package's surface as the cases use it."""

    def __init__(self, pkg, comm, apply_function):
        self.pkg, self.comm, self.apply_function = pkg, comm, apply_function

    def enc(self, a, requires_grad):
        return self.pkg.cryptensor(np.asarray(a, dtype=np.float64), requires_grad=requires_grad)

    def cat(self, tensors, dim=0):
        return self.pkg.cat(tensors, dim)

    def stack(self, tensors, dim=0):
        return self.pkg.stack(tensors, dim)


def port_lib():
    return Lib(ct, ct.comm, autograd.apply_function)


def _unary(arrays, fn, **kw):
    return [Run(arrays, fn, **kw)]


def _cases():
    """name -> (numpy Generator -> [Run]): test_gradients_sweep.py's cases."""
    c = {}
    n = lambda R, *s: R.normal(size=s)  # noqa: E731
    c["add"] = lambda R: _unary([n(R, 3, 4), n(R, 3, 4)], lambda L, a, b: a.add(b),
                                plain=lambda a, b: a + b)
    c["sub"] = lambda R: _unary([n(R, 3, 4), n(R, 4)], lambda L, a, b: a.sub(b),
                                plain=lambda a, b: a - b)
    c["neg"] = lambda R: _unary([n(R, 5)], lambda L, a: a.neg(), plain=lambda a: -a)
    c["mul"] = lambda R: _unary([n(R, 3, 4), n(R, 3, 4)], lambda L, a, b: a.mul(b),
                                plain=lambda a, b: a * b)
    c["div"] = lambda R: _unary([n(R, 6)], lambda L, a: a.div(4.0), plain=lambda a: a / 4.0)
    c["square"] = lambda R: _unary([n(R, 5)], lambda L, a: a.square(), plain=lambda a: a * a)
    c["matmul"] = lambda R: _unary([n(R, 4, 3), n(R, 3, 2)], lambda L, a, b: a.matmul(b),
                                   tol=0.05, plain=lambda a, b: a @ b)
    c["dot"] = lambda R: _unary([n(R, 6), n(R, 6)], lambda L, a, b: a.dot(b), tol=0.05,
                                plain=lambda a, b: (a * b).sum())
    c["ger"] = lambda R: _unary([n(R, 4), n(R, 3)], lambda L, a, b: a.ger(b), tol=0.05,
                                plain=torch.outer)
    c["pow"] = lambda R: _unary([n(R, 5) * 0.8], lambda L, a: a.pow(3), tol=0.1,
                                plain=lambda a: a ** 3)

    def pos_pow(R):
        a = np.abs(n(R, 5)) + 1.0
        return [Run([a], lambda L, x: x.pos_pow(2), tol=0.1, plain=lambda x: x ** 2),
                Run([a], lambda L, x: x.pos_pow(1.5), tol=0.3, grad_tol=0.25,
                    plain=lambda x: x ** 1.5),
                Run([np.array([1.3, 1.6])], lambda L, x: x.pos_pow(2.5), tol=0.4, grad_tol=0.5,
                    plain=lambda x: x ** 2.5)]

    c["pos_pow"] = pos_pow
    c["polynomial"] = lambda R: _unary([n(R, 5) * 0.5],
                                       lambda L, x: x.polynomial([1.0, 0.5, 0.25]), tol=0.1,
                                       plain=lambda x: x + 0.5 * x ** 2 + 0.25 * x ** 3)
    c["exp"] = lambda R: _unary([n(R, 5)], lambda L, a: a.exp(), tol=0.3,
                                plain=torch.exp)
    c["log"] = lambda R: _unary([np.abs(n(R, 5)) * 2 + 1.0], lambda L, x: x.log(), tol=0.1,
                                grad_tol=0.3, plain=torch.log)
    c["reciprocal"] = lambda R: _unary([np.abs(n(R, 5)) + 1.0], lambda L, x: x.reciprocal(),
                                       tol=0.2, grad_tol=0.3, plain=lambda x: 1 / x)
    c["sqrt"] = lambda R: _unary([np.abs(n(R, 5)) * 3 + 1.0], lambda L, x: x.sqrt(), tol=0.3,
                                 plain=torch.sqrt)
    c["sigmoid"] = lambda R: _unary([n(R, 6) * 2], lambda L, a: a.sigmoid(), tol=0.08,
                                    grad_tol=0.1, plain=torch.sigmoid)
    c["tanh"] = lambda R: _unary([n(R, 6) * 2], lambda L, a: a.tanh(), tol=0.15, grad_tol=0.2,
                                 plain=torch.tanh)
    c["erf"] = lambda R: _unary([n(R, 6)], lambda L, a: a.erf(), tol=0.05, grad_tol=0.2,
                                plain=torch.erf)
    c["gelu"] = lambda R: _unary([n(R, 6) * 2], lambda L, a: a.gelu(), tol=0.05, grad_tol=0.2,
                                 plain=F.gelu)
    c["silu"] = lambda R: _unary([n(R, 6) * 2], lambda L, a: a.silu(), tol=0.05, grad_tol=0.2,
                                 plain=F.silu)
    c["relu"] = lambda R: _unary([n(R, 8)], lambda L, a: a.relu(), plain=torch.relu)
    c["relu6"] = lambda R: _unary([np.array([-2.0, 0.5, 3.0, 5.5, 7.0, 9.0])],
                                  lambda L, a: L.apply_function("relu6", a), tol=0.05,
                                  plain=F.relu6)
    c["hardtanh"] = lambda R: _unary([n(R, 8) * 2], lambda L, a: a.hardtanh(-1.0, 1.0), tol=0.05,
                                     plain=F.hardtanh)
    c["abs"] = lambda R: _unary([n(R, 8)], lambda L, a: a.abs(), plain=torch.abs)
    c["sign"] = lambda R: _unary([n(R, 6)], lambda L, a: a.sign(),
                                 plain=lambda a: torch.sign(a) + 0 * a)
    c["sin"] = lambda R: _unary([R.uniform(-3, 3, size=(6,))], lambda L, a: a.sin(), tol=0.05,
                                grad_tol=0.1, plain=torch.sin)
    c["cos"] = lambda R: _unary([R.uniform(-3, 3, size=(6,))], lambda L, a: a.cos(), tol=0.05,
                                grad_tol=0.1, plain=torch.cos)
    c["cosine_similarity"] = lambda R: _unary(
        [n(R, 2, 4) * 2, n(R, 2, 4) * 2],
        lambda L, a, b: L.apply_function("cosine_similarity", a, b, 1), tol=0.15, grad_tol=0.3,
        plain=lambda a, b: F.cosine_similarity(a, b, dim=1))

    def norm(R):
        a = n(R, 5) * 2
        b = n(R, 3, 4) + np.sign(n(R, 3, 4)) * 0.8
        return [Run([a], lambda L, x: x.norm(), tol=0.15, grad_tol=0.3, plain=torch.norm),
                Run([b], lambda L, x: x.norm(p=2, dim=1), tol=0.2, grad_tol=0.3,
                    plain=lambda x: x.norm(p=2, dim=1))]

    c["norm"] = norm
    c["dropout"] = lambda R: _unary([np.abs(n(R, 64)) + 1.0], lambda L, a: a.dropout(p=0.3),
                                    tol=0.05, random=True)
    c["_feature_dropout"] = lambda R: _unary(
        [np.abs(n(R, 4, 3, 5)) + 1.0], lambda L, a: L.apply_function("_feature_dropout", a, 0.4),
        tol=0.05, random=True)
    # structure
    c["view"] = lambda R: _unary([n(R, 2, 3)], lambda L, a: a.view(6), plain=lambda a: a.reshape(6))
    c["reshape"] = lambda R: _unary([n(R, 2, 3)], lambda L, a: a.reshape(3, 2),
                                   plain=lambda a: a.reshape(3, 2))
    c["flatten"] = lambda R: _unary([n(R, 2, 3)], lambda L, a: a.flatten(), plain=torch.flatten)
    c["squeeze"] = lambda R: _unary([n(R, 3, 1, 2)], lambda L, a: a.squeeze(1),
                                    plain=lambda a: a.squeeze(1))
    c["unsqueeze"] = lambda R: _unary([n(R, 3, 2)], lambda L, a: a.unsqueeze(1),
                                     plain=lambda a: a.unsqueeze(1))
    c["t"] = lambda R: _unary([n(R, 3, 2)], lambda L, a: a.t(), plain=torch.t)
    c["transpose"] = lambda R: _unary([n(R, 2, 3, 4)], lambda L, a: a.transpose(0, 2),
                                     plain=lambda a: a.transpose(0, 2))
    c["permute"] = lambda R: _unary([n(R, 2, 3, 4)], lambda L, a: a.permute(2, 0, 1),
                                   plain=lambda a: a.permute(2, 0, 1))
    c["roll"] = lambda R: _unary([n(R, 5)], lambda L, a: a.roll(2, 0), plain=lambda a: a.roll(2, 0))
    c["flip"] = lambda R: _unary([n(R, 5)], lambda L, a: a.flip(0), plain=lambda a: a.flip(0))
    c["narrow"] = lambda R: _unary([n(R, 4, 3)], lambda L, a: a.narrow(0, 1, 2),
                                  plain=lambda a: a.narrow(0, 1, 2))
    c["clone"] = lambda R: _unary([n(R, 4)], lambda L, a: a.clone(), plain=torch.clone)
    c["cat"] = lambda R: _unary([n(R, 2, 3), n(R, 4, 3)], lambda L, a, b: L.cat([a, b], 0),
                               plain=lambda a, b: torch.cat([a, b], 0))
    c["stack"] = lambda R: _unary([n(R, 2, 3), n(R, 2, 3)], lambda L, a, b: L.stack([a, b], 0),
                                 plain=lambda a, b: torch.stack([a, b], 0))
    c["getitem"] = lambda R: _unary([n(R, 4, 3)], lambda L, a: L.apply_function("getitem", a, 1),
                                   plain=lambda a: a[1])
    c["__getitem__"] = lambda R: _unary([n(R, 5)], lambda L, a: a[1:3], plain=lambda a: a[1:3])
    c["__rsub__"] = lambda R: _unary([n(R, 5)], lambda L, a: 2.0 - a, plain=lambda a: 2.0 - a)
    c["__rtruediv__"] = lambda R: _unary([np.abs(n(R, 5)) + 1.0], lambda L, x: 2.0 / x, tol=0.3,
                                         grad_tol=0.5, plain=lambda x: 2.0 / x)
    c["index_select"] = lambda R: _unary([n(R, 4, 3)],
                                         lambda L, a: a.index_select(0, np.array([0, 2])),
                                         plain=lambda a: a[[0, 2]])
    c["gather"] = lambda R: _unary([n(R, 2, 3)],
                                   lambda L, a: a.gather(1, np.array([[0, 1], [1, 0]])),
                                   plain=lambda a: a.gather(1, torch.tensor([[0, 1], [1, 0]])))
    c["scatter"] = lambda R: _unary([n(R, 2, 3), n(R, 2, 1)],
                                    lambda L, a, s: a.scatter(1, np.array([[0], [1]]), s),
                                    plain=lambda a, s: a.scatter(1, torch.tensor([[0], [1]]), s))
    c["take"] = lambda R: _unary([n(R, 2, 3)], lambda L, a: a.take(np.array([0, 3, 5])),
                                 plain=lambda a: a.take(torch.tensor([0, 3, 5])))
    c["trace"] = lambda R: _unary([n(R, 3, 3)], lambda L, a: a.trace(), plain=torch.trace)
    c["cumsum"] = lambda R: _unary([n(R, 5)], lambda L, a: a.cumsum(0), plain=lambda a: a.cumsum(0))
    c["pad"] = lambda R: _unary([n(R, 4)], lambda L, a: a.pad((1, 2)),
                                plain=lambda a: F.pad(a, (1, 2)))
    # reductions
    c["sum"] = lambda R: _unary([n(R, 3, 4)], lambda L, a: a.sum(0), plain=lambda a: a.sum(0))
    c["mean"] = lambda R: _unary([n(R, 3, 4)], lambda L, a: a.mean(0), plain=lambda a: a.mean(0))
    c["var"] = lambda R: _unary([n(R, 4, 3)], lambda L, a: a.var(0), tol=0.05, grad_tol=0.1,
                                plain=lambda a: a.var(0, unbiased=False))
    c["min"] = lambda R: _unary([n(R, 6)], lambda L, a: a.min(), tol=0.05, backward="self",
                                plain=torch.min)
    c["max"] = lambda R: _unary([n(R, 6)], lambda L, a: a.max(), tol=0.05, backward="self",
                                plain=torch.max)
    c["softmax"] = lambda R: _unary([n(R, 2, 4)], lambda L, a: a.softmax(-1), tol=0.08,
                                    grad_tol=0.1, plain=lambda a: a.softmax(-1))
    c["log_softmax"] = lambda R: _unary([n(R, 2, 4)], lambda L, a: a.log_softmax(-1), tol=0.15,
                                        grad_tol=0.2, plain=lambda a: a.log_softmax(-1))
    # conv / pool
    c["conv1d"] = lambda R: _unary([n(R, 1, 2, 8), n(R, 3, 2, 3)], lambda L, a, w: a.conv1d(w),
                                   tol=0.05, grad_tol=0.1, plain=F.conv1d)
    c["conv2d"] = lambda R: _unary([n(R, 1, 2, 5, 5), n(R, 3, 2, 3, 3)],
                                   lambda L, a, w: a.conv2d(w), tol=0.05, grad_tol=0.1,
                                   plain=F.conv2d)
    c["avg_pool2d"] = lambda R: _unary([n(R, 1, 2, 4, 4)], lambda L, a: a.avg_pool2d(2), tol=0.05,
                                       plain=lambda a: F.avg_pool2d(a, 2))
    c["max_pool2d"] = lambda R: _unary([n(R, 1, 1, 4, 4)], lambda L, a: a.max_pool2d(2), tol=0.05,
                                       plain=lambda a: F.max_pool2d(a, 2))

    def layernorm(R):
        # rows of variance below 1 (inv_sqrt's fine cells) and a gradient
        # that is not constant over a row: the sweep's sum of the outputs
        # has a zero input gradient, which would not test the backward
        # curl_tpu completed (gradients.py:886)
        a = n(R, 2, 6) * 0.6
        up = n(R, 2, 6)
        return [Run([a, np.ones(6), np.zeros(6)],
                    lambda L, x, w, b: L.apply_function("layernorm", x, w, b, (1,)).mul(up),
                    tol=0.12, grad=[True, False, False],
                    plain=lambda x, w, b: F.layer_norm(x, (6,), w, b) * torch.tensor(up))]

    c["layernorm"] = layernorm

    def batchnorm(R):
        a = n(R, 4, 3)
        w = np.abs(n(R, 3)) + 0.5
        b = n(R, 3)
        return [Run([a, w, b],
                    lambda L, x, ww, bb: L.apply_function("batchnorm", x, ww, bb, training=True),
                    tol=0.25, grad_tol=0.3, plain=_batchnorm_unbiased)]

    c["batchnorm"] = batchnorm
    c["attention"] = lambda R: _unary(
        [n(R, 1, 3, 4) * 0.5, n(R, 1, 3, 4) * 0.5, n(R, 1, 3, 4) * 0.5],
        lambda L, q, k, v: L.apply_function("attention", q, k, v), tol=0.1, grad_tol=0.15,
        plain=lambda q, k, v: (q @ k.transpose(-2, -1) / 2.0).softmax(-1) @ v)

    # losses: a public target drawn after the input
    def loss(name, make, plain, *extra, tol=0.15, grad_tol=0.1):
        def case(R):
            x, y = make(R)
            return [Run([x], lambda L, e: L.apply_function(name, e, y, *extra), tol=tol,
                        grad_tol=grad_tol, backward="self",
                        plain=lambda t: plain(t, torch.tensor(y)))]
        return case

    def probs(R):
        return R.uniform(0.15, 0.85, size=(6,)), (R.uniform(size=(6,)) > 0.5).astype(np.float64)

    def logits(R):
        return n(R, 6), (R.uniform(size=(6,)) > 0.5).astype(np.float64)

    def onehot(R):
        x = n(R, 4, 5)
        return x, np.eye(5)[R.integers(0, 5, size=(4,))]

    c["binary_cross_entropy"] = loss("binary_cross_entropy", probs, F.binary_cross_entropy,
                                     grad_tol=0.5)
    c["binary_cross_entropy_with_logits"] = loss("binary_cross_entropy_with_logits", logits,
                                                 F.binary_cross_entropy_with_logits)
    c["rappor_loss"] = loss("rappor_loss", logits, F.binary_cross_entropy_with_logits, 0.0)
    c["cross_entropy"] = loss("cross_entropy", onehot,
                              lambda t, y: F.cross_entropy(t, y.argmax(-1)), tol=0.25)
    return c


def _batchnorm_unbiased(x, w, b):
    """Training BatchNorm as curl_tpu computes it: by the batch's unbiased
    variance (curl_tpu/gradients.py:1390; torch's F.batch_norm takes the
    biased)."""
    mean = x.mean(0, keepdim=True)
    var = x.var(0, unbiased=True, keepdim=True)
    return (x - mean) / (var + 1e-5).sqrt() * w + b


CASES = _cases()


def _probe_inputs(name):
    """A fault probe's inputs, from its seed: the batchnorm probe's (x,
    weight, bias, a gradient that is not constant over the batch), the
    matmul probe's (x, a square public operand that is not symmetric)."""
    R = np.random.default_rng(case_seed(name))
    if name == "batchnorm_training":
        # variances below 1, where inv_sqrt's table is fine (above 1 its
        # cells err by up to 0.17, which would hide the formula)
        return R.normal(size=(4, 3)) * 0.6, np.abs(R.normal(size=3)) + 0.5, R.normal(size=3), \
            R.normal(size=(4, 3))
    return R.normal(size=(4, 3)), R.normal(size=(3, 3))


def _faults():
    """Where curl_tpu's gradient is not float64's (ROADMAP Queue C): the
    probes that show it, whose readings curl_tpu's golden keeps too."""

    def batchnorm(R):
        a, w, b, up = _probe_inputs("batchnorm_training")
        return [Run([a, w, b], lambda L, x, ww, bb: L.apply_function(
                    "batchnorm", x, ww, bb, training=True).mul(up), tol=0.25, grad_tol=0.3,
                    grad=[True, False, False],
                    plain=lambda x, ww, bb: _batchnorm_unbiased(x, ww, bb) * torch.tensor(up))]

    def matmul_public(R):
        a, b = _probe_inputs("matmul_public_right")
        return [Run([a], lambda L, x: x.matmul(b), tol=0.05, plain=lambda x: x @ torch.tensor(b))]

    return {"batchnorm_training": batchnorm, "matmul_public_right": matmul_public}


FAULTS = _faults()


def case_seed(name):
    """Each case's session seed and input seed (the sweep's)."""
    return zlib.crc32(name.encode())


def run_case(lib, name, init, table=None):
    """The readings of case ``name`` of ``table`` (default ``CASES``) in
    ``lib``'s package under ``init(seed)``: {key: decoded array}, the
    rounds and bytes of every forward and backward (the inputs' encryption
    apart), and the runs."""
    seed = case_seed(name)
    init(seed)
    runs = (CASES if table is None else table)[name](np.random.default_rng(seed))
    out = {}
    lib.comm.reset_communication_stats()
    for j, run in enumerate(runs):
        encs = [lib.enc(a, g) for a, g in zip(run.arrays, run.grad)]
        y = run.fn(lib, *encs)
        out[f"{j}/out"] = np.asarray(y.get_plain_text(), dtype=np.float64)
        (y if run.backward == "self" else y.sum()).backward()
        for i, (e, g) in enumerate(zip(encs, run.grad)):
            if g:
                assert e.grad is not None, f"{name}: no gradient for input {i}"
                out[f"{j}/grad{i}"] = np.asarray(e.grad.get_plain_text(), dtype=np.float64)
    stats = lib.comm.get_communication_stats()
    return out, (int(stats["rounds"]), int(stats["bytes"])), runs


def plain_readings(name, table=None):
    """Each run's output and input gradients in float64 torch, keyed as
    ``run_case``'s (the random cases' runs left out)."""
    out = {}
    runs = (CASES if table is None else table)[name](np.random.default_rng(case_seed(name)))
    for j, run in enumerate(runs):
        if run.random:
            continue
        ts = [torch.tensor(np.asarray(a, dtype=np.float64), requires_grad=g)
              for a, g in zip(run.arrays, run.grad)]
        y = run.plain(*ts)
        out[f"{j}/out"] = y.detach().numpy()
        (y if run.backward == "self" else y.sum()).backward()
        for i, (t, g) in enumerate(zip(ts, run.grad)):
            if g:
                out[f"{j}/grad{i}"] = t.grad.numpy()
    return out


def _port_init(seed):
    ct.init(world_size=2, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_every_registered_function_has_a_case():
    """The port's registry is curl_tpu's, name for name (gradients.py
    registers 74 functions and the ``__getitem__`` alias), and each has a
    case."""
    assert len(autograd.FUNCTION_REGISTRY) == 75
    assert set(CASES) == set(autograd.FUNCTION_REGISTRY)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_against_curl_tpu(name, golden):
    """The port's output and input gradients within curl_tpu's sweep
    tolerances of float64 (the bar curl_tpu's own sweep sets curl_tpu),
    within twice them of curl_tpu's readings (both meet that bar, and they
    may differ by a LUT cell at a cell's edge, tests/test_reference_parity.py
    :18-21), and the rounds and bytes curl_tpu's."""
    out, counts, runs = run_case(port_lib(), name, _port_init)
    assert counts == tuple(golden[f"{name}/counts"]), (name, counts)
    plain = plain_readings(name)
    for j, run in enumerate(runs):
        if run.random:
            # the masks are each package's own: held to the port's mask
            a = run.arrays[0]
            pt = out[f"{j}/out"]
            keep = (np.abs(pt) > 1e-6).astype(float)
            if a.ndim == 3:  # whole channels dropped
                keep = np.broadcast_to((np.abs(pt).sum(-1) > 1e-6)[..., None], a.shape)
            scale = 1 / (1 - (0.3 if name == "dropout" else 0.4))
            np.testing.assert_allclose(pt, a * keep * scale, atol=run.tol)
            np.testing.assert_allclose(out[f"{j}/grad0"], keep * scale, atol=run.tol)
            assert 0 < keep.mean() < 1
            continue
        keys = [("out", run.tol)] + [(f"grad{i}", run.grad_tol)
                                     for i, g in enumerate(run.grad) if g]
        for key, tol in keys:
            k = f"{j}/{key}"
            np.testing.assert_allclose(out[k], plain[k], atol=tol, rtol=0,
                                       err_msg=f"{name} {k} against float64")
            np.testing.assert_allclose(out[k], golden[f"{name}/{k}"], atol=2 * tol, rtol=0,
                                       err_msg=f"{name} {k} against curl_tpu")


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_gradient_fault_of_the_reference(name, golden):
    """curl_tpu's gradient is not float64's on these probes (ROADMAP Queue
    C): its readings miss float64's by more than the sweep's tolerance and
    meet the formula it computes; the port's meet float64's, at curl_tpu's
    rounds and bytes."""
    out, counts, runs = run_case(port_lib(), name, _port_init, table=FAULTS)
    assert counts == tuple(golden[f"faults/{name}/counts"])
    plain = plain_readings(name, table=FAULTS)
    run = runs[0]
    ref = golden[f"faults/{name}/0/grad0"]
    np.testing.assert_allclose(out["0/grad0"], plain["0/grad0"], atol=run.grad_tol, rtol=0)
    np.testing.assert_allclose(out["0/out"], golden[f"faults/{name}/0/out"], atol=2 * run.tol)
    assert np.max(np.abs(ref - plain["0/grad0"])) > run.grad_tol
    np.testing.assert_allclose(ref, _reference_formula(name), atol=run.grad_tol / 3)


def _reference_formula(name):
    """The input gradient curl_tpu's formula gives on probe ``name``, in
    float64: grad @ b for the matmul (curl_tpu/gradients.py:137), the
    biased variance's gradient for the batchnorm (curl_tpu/gradients.py:
    1424-1430)."""
    if name == "matmul_public_right":
        x, b = _probe_inputs(name)
        return np.ones((x.shape[0], b.shape[1])) @ b
    x, w, _, up = (torch.tensor(v) for v in _probe_inputs(name))
    n = x.shape[0]
    inv = 1 / (x.var(0, unbiased=True, keepdim=True) + 1e-5).sqrt()
    xn = (x - x.mean(0, keepdim=True)) * inv
    gout = up * w
    return (gout * inv - gout.sum(0, keepdim=True) * inv / n
            - xn * (xn * gout).sum(0, keepdim=True) * inv / n).numpy()


@pytest.mark.parametrize("padding,stride", [(0, 2), (0, 1), (1, 2)])
def test_max_pool_backward_scatters_like_float64(padding, stride):
    """``_max_pool2d_backward``'s indexed add: overlapping windows
    (stride below the window) sum their gradients into shared positions,
    and a padded border's gradient is cut off, as float64 torch's."""
    _port_init(17)
    rng = np.random.default_rng(17)
    x = rng.normal(size=(2, 2, 6, 6))
    up = rng.normal(size=F.max_pool2d(torch.tensor(x), 3, stride, padding).shape)
    t = torch.tensor(x, requires_grad=True)
    (F.max_pool2d(t, 3, stride, padding) * torch.tensor(up)).sum().backward()
    xe = ct.cryptensor(x, requires_grad=True)
    out = xe.max_pool2d(3, stride=stride, padding=padding)
    out.mul(up).sum().backward()
    np.testing.assert_allclose(out.get_plain_text(), F.max_pool2d(torch.tensor(x), 3, stride,
                                                                  padding).numpy(), atol=0.02)
    np.testing.assert_allclose(xe.grad.get_plain_text(), t.grad.numpy(), atol=0.02)


def test_grouped_conv_backward_raises():
    """A grouped convolution's backward raises, as curl_tpu's does
    (curl_tpu/gradients.py:766)."""
    _port_init(18)
    rng = np.random.default_rng(18)
    x = ct.cryptensor(rng.normal(size=(1, 4, 5, 5)), requires_grad=True)
    w = ct.cryptensor(rng.normal(size=(2, 2, 3, 3)), requires_grad=True)
    out = x.conv2d(w, groups=2)
    with pytest.raises(NotImplementedError, match="grouped conv backward"):
        out.sum().backward()
