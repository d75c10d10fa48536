"""Bring your own model: the port's ``from_pytorch``, ``from_onnx``, ONNX op
modules, ``PlainTensor``, ``graph_to_dot`` and ``where`` against curl_tpu and
float64.

* Converted models (``CONVERT_CASES``: an MLP with softmax, a convnet,
  BatchNorm with an average pool, a torchvision-layout residual block, a
  Sequential), weights and inputs from numpy seeds, through
  ``from_pytorch`` and through ``from_onnx`` of the same ONNX bytes (torch's
  export, with and without its constant folding, which folds each
  BatchNorm into its convolution), encrypted: the decoded output within
  0.05 (tests/test_onnx_converter.py's tolerance) of torch's and of
  curl_tpu's, rounds and bytes equal curl_tpu's; unencrypted through
  ``PlainTensor`` within 1e-9 of torch's float64 forward. The unfolded
  export's BatchNorm takes its running statistics as encrypted
  initializers, as curl_tpu's does, and computes 1 / sqrt(var + eps) by the
  private inv_sqrt, whose cells above 1 are 1 wide under the default
  configuration, and where a truncation moves a variance across a cell
  the two packages differ by up to that cell's error: that route is held
  to the sweep's BatchNormalization tolerance, 0.2.
* Every ONNX op class (``OP_CASES``, tests/test_onnx_ops_sweep.py's sweep):
  the private output within the sweep's tolerance of float64 and of
  curl_tpu's, rounds and bytes curl_tpu's; through PlainTensor within 1e-9
  of float64. The containers (``Graph``'s diamond, several outputs, a
  disconnected graph, node names holding ``.``, ``ModuleList``,
  ``ModuleDict``) and ``Parameter``.
* ``onnx_lite`` parsing initializers and attributes; ``from_onnx`` from a
  file path; ``graph_to_dot``; the top-level ``where``.

curl_tpu's readings (its eager runs take seconds a case) are in
``tests/golden/torch_convert_reference.npz``, written by
``JAX_PLATFORMS=cpu python3 tests/torch_convert_reference.py``, with the
ONNX bytes both packages read.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch.nn import onnx_ops  # noqa: E402
from curl_tpu_torch.nn.plain import PlainTensor, unwrap_plain, wrap_plain  # noqa: E402
from curl_tpu_torch.nn.tensorboard import SummaryWriter, graph_to_dot  # noqa: E402
from curl_tpu_torch.utils import onnx_lite  # noqa: E402
from curl_tpu_torch.utils.torch_onnx_export import export_onnx_bytes  # noqa: E402

from chip_smoke import TorchBasicBlock  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_convert_reference.npz")
SESSION_SEED = 1234
# tests/test_onnx_converter.py:19
ATOL = 0.05
PLAIN_RTOL = 1e-9
F = torch.nn.functional


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

class MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(8, 16)
        self.fc2 = torch.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x))).softmax(-1)


class ConvNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 4, 3, padding=1)
        self.pool = torch.nn.MaxPool2d(2)
        self.fc = torch.nn.Linear(4 * 4 * 4, 5)

    def forward(self, x):
        h = self.pool(torch.relu(self.conv(x)))
        return self.fc(h.flatten(1))


class BNAvgPool(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(2, 3, 3)
        self.bn = torch.nn.BatchNorm2d(3)
        self.pool = torch.nn.AvgPool2d(2)

    def forward(self, x):
        return self.pool(self.bn(self.conv(x)))


class Residual(torch.nn.Module):
    """A stem and one torchvision BasicBlock at 8 channels (an in-place
    ReLU, ``out += identity``), ``AdaptiveAvgPool2d``, ``torch.flatten``
    and a Linear: torchvision's ResNet layout at one block."""

    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.bn1 = torch.nn.BatchNorm2d(8)
        self.relu = torch.nn.ReLU(inplace=True)
        self.layer1 = torch.nn.Sequential(TorchBasicBlock(8, 8))
        self.avgpool = torch.nn.AdaptiveAvgPool2d((1, 1))
        self.fc = torch.nn.Linear(8, 4)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.layer1(x)
        x = torch.flatten(self.avgpool(x), 1)
        return self.fc(x)


def _sequential():
    nn = torch.nn
    return nn.Sequential(nn.Conv2d(1, 2, 3), nn.ReLU(), nn.Flatten(), nn.Linear(2 * 6 * 6, 3))


# name -> (the torch model, the input's shape, numpy seed)
MODELS = {
    "mlp": (MLP, (2, 8), 0),
    "convnet": (ConvNet, (1, 1, 8, 8), 2),
    "bn_avgpool": (BNAvgPool, (1, 2, 6, 6), 3),
    "residual": (Residual, (1, 3, 8, 8), 4),
    "sequential": (_sequential, (1, 1, 8, 8), 5),
}
# (model, route): "pytorch", "onnx" (torch's export without constant
# folding, as export_onnx_bytes makes it), "onnx folded" (with it)
CONVERT_CASES = [(m, r) for m in MODELS for r in ("pytorch", "onnx")] + [
    ("bn_avgpool", "onnx folded"), ("residual", "onnx folded")]
# the unfolded exports, whose BatchNorm runs the private inv_sqrt of an
# encrypted variance: held to tests/test_onnx_ops_sweep.py's tolerance for
# that node (its BatchNormalization case), against torch and curl_tpu alike
INV_SQRT_ROUTES = {("bn_avgpool", "onnx"), ("residual", "onnx")}
INV_SQRT_ATOL = 0.2


def torch_model(name):
    """The float32 torch model ``name`` in eval mode, every parameter and
    BatchNorm statistic drawn in state dict order from its numpy seed:
    weights N(0, 2 / fan_in), BatchNorm gains 1 + 0.1 N(0, 1), biases and
    running means 0.1 N(0, 1), running variances uniform in [0.5, 2]."""
    build, _, seed = MODELS[name]
    net = build()
    rng = np.random.default_rng(100 + seed)
    state = {}
    for key, v in net.state_dict().items():
        shape = tuple(v.shape)
        if key.endswith("num_batches_tracked"):
            state[key] = v
            continue
        if key.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif len(shape) > 1:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif key.endswith("weight") and "bn" in key:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        state[key] = torch.as_tensor(a, dtype=torch.float32)
    net.load_state_dict(state)
    return net.eval()


def model_input(name):
    _, shape, seed = MODELS[name]
    return np.random.default_rng(seed).normal(size=shape) * 0.5


def torch_reference(name):
    """The torch model's float64 forward (its float32 weights exactly)."""
    net = copy.deepcopy(torch_model(name)).double()
    with torch.no_grad():
        return net(torch.as_tensor(model_input(name), dtype=torch.float64)).numpy()


def export(name, folding):
    """torch's ONNX export of the model in float64 (its float32 weights
    exactly), as phase 13 exports on the card: a folded BatchNorm's weights
    are then float64's, and the graph run in the clear is float64's."""
    x = torch.as_tensor(model_input(name), dtype=torch.float64)
    return export_onnx_bytes(torch_model(name).double(), x, do_constant_folding=folding)


def onnx_key(name, route):
    return f"{name}/{route.replace(' ', '_')}/bytes"


def convert(nn_pkg, name, route, data=None):
    """The model converted by ``nn_pkg``'s converter (the port's or
    curl_tpu's): from the torch model, or from ONNX ``data``."""
    if route == "pytorch":
        return nn_pkg.from_pytorch(torch_model(name))
    return nn_pkg.from_onnx(data)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _init(seed=SESSION_SEED):
    ct.init(world_size=2, seed=seed, device="cpu")


def _decoded(out):
    if hasattr(out, "get_plain_text"):
        return np.asarray(out.get_plain_text())
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def private_run(pkg, graph, x):
    """(decoded output, rounds, bytes) of ``graph`` encrypted by party 0
    on the encrypted input, in ``pkg`` (either package)."""
    from curl_tpu_torch import comm

    graph.encrypt(src=0)
    xe = pkg.cryptensor(x)
    counts = comm if pkg is ct else _jax_comm()
    with pkg.no_grad():
        counts.reset_communication_stats()
        out = _decoded(graph(xe))
        stats = counts.get_communication_stats()
    return out, stats["rounds"], stats["bytes"]


def _jax_comm():
    from curl_tpu import comm

    return comm


@pytest.mark.parametrize("name,route", CONVERT_CASES, ids=[f"{m}-{r}" for m, r in CONVERT_CASES])
def test_converted_model_like_curl_tpu_and_torch(name, route, golden):
    """Private: within 0.05 of torch's and curl_tpu's outputs, at
    curl_tpu's rounds and bytes; in the clear within 1e-9 of float64."""
    _init()
    data = None if route == "pytorch" else golden[onnx_key(name, route)].tobytes()
    x = model_input(name)
    ref = torch_reference(name)
    # a Sequential takes a PlainTensor; a Graph or GraphModule wraps x itself
    plain = unwrap_plain(convert(ct.nn, name, route, data)(wrap_plain(x)))
    np.testing.assert_allclose(plain, ref, rtol=PLAIN_RTOL, atol=PLAIN_RTOL * np.abs(ref).max())
    out, rounds, nbytes = private_run(ct, convert(ct.nn, name, route, data), x)
    key = f"{name}/{route.replace(' ', '_')}"
    want = golden[f"{key}/output"]
    assert out.shape == ref.shape == want.shape
    assert (rounds, nbytes) == tuple(int(v) for v in golden[f"{key}/counts"])
    atol = INV_SQRT_ATOL if (name, route) in INV_SQRT_ROUTES else ATOL
    np.testing.assert_allclose(out, want, atol=atol)
    np.testing.assert_allclose(out, ref, atol=atol)
    np.testing.assert_allclose(want, ref, atol=atol)


def test_golden_onnx_bytes_are_this_torch_export():
    """The golden file's ONNX bytes parse to the graph this torch exports
    (the same op types and initializer values)."""
    for name, route in CONVERT_CASES:
        if route == "pytorch":
            continue
        with np.load(GOLDEN) as z:
            stored = onnx_lite.load_model(z[onnx_key(name, route)].tobytes()).graph
        fresh = onnx_lite.load_model(export(name, route == "onnx folded")).graph
        assert [n.op_type for n in stored.nodes] == [n.op_type for n in fresh.nodes]
        for a, b in zip(stored.initializers, fresh.initializers):
            np.testing.assert_array_equal(a.array, b.array)


def test_from_pytorch_structure():
    """A Sequential of convertible leaves converts to the port's
    Sequential; any other model to a GraphModule whose submodules are the
    traced targets with "." as "__"; every tensor a float64 copy."""
    seq = ct.nn.from_pytorch(torch_model("sequential"))
    assert isinstance(seq, ct.nn.Sequential)
    assert [type(m).__name__ for m in seq] == ["Conv2d", "ReLU", "Flatten", "Linear"]
    res = ct.nn.from_pytorch(torch_model("residual"))
    names = dict(res.named_children())
    assert "layer1__0__conv1" in names and "layer1__0__bn2" in names
    assert res.layer1__0__bn2.running_var.dtype == torch.float64
    assert all(p.dtype == torch.float64 for _, p in res.named_parameters())

    class Unconvertible(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lstm = torch.nn.GRUCell(4, 4)
            self.fc = torch.nn.Linear(4, 2)

        def forward(self, x):
            return self.fc(x)

    # an unconvertible leaf that the graph never calls is skipped
    _init()
    out = ct.nn.from_pytorch(Unconvertible())(np.ones((1, 4)))
    assert unwrap_plain(out).shape == (1, 2)
    with pytest.raises(NotImplementedError):
        ct.nn.from_tensorflow(None)


# ---------------------------------------------------------------------------
# the ONNX op modules (tests/test_onnx_ops_sweep.py's sweep)
# ---------------------------------------------------------------------------

def _u(lo, hi, shape):
    return ("u", lo, hi, shape)


def _n(shape, scale=1.0):
    return ("n", scale, shape)


def _draw(rng, spec):
    if spec[0] == "u":
        return rng.uniform(spec[1], spec[2], size=spec[3])
    return rng.normal(size=spec[2]) * spec[1]


def _pool(kind, x, k, s, p=0):
    t = torch.as_tensor(x)
    return (F.avg_pool2d(t, k, s, padding=p) if kind == "avg"
            else F.max_pool2d(t, k, s, padding=p)).numpy()


def _bn(x, w, b, m, v):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - m.reshape(shape)) / np.sqrt(v.reshape(shape) + 1e-5) * w.reshape(shape) + \
        b.reshape(shape)


def _ln(x, w, b):
    return (x - x.mean(-1, keepdims=True)) / np.sqrt(x.var(-1, keepdims=True) + 1e-5) * w + b


def _slice(x, starts, ends, axes):
    sl = [slice(None)] * x.ndim
    for i, (s, e) in enumerate(zip(starts, ends)):
        ax = axes[i] if axes else i
        n = x.shape[ax]
        sl[ax] = slice(max(s + n, 0) if s < 0 else min(s, n), max(e + n, 0) if e < 0 else min(e, n))
    return x[tuple(sl)]


def _conv(x, w, b=None, **kw):
    fn = F.conv2d if w.ndim == 4 else F.conv1d
    return fn(torch.as_tensor(x), torch.as_tensor(w),
              None if b is None else torch.as_tensor(b), **kw).numpy()


def _erf(x):
    return torch.erf(torch.as_tensor(x)).numpy()


def _binary(name, mode):
    fns = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply, "Div": np.divide}
    a, b = mode.split("_")
    # private division goes through the reciprocal LUT, accurate on [2, 32]
    divisor = _u(2.0, 8.0, (3, 4)) if name == "Div" else _u(0.5, 2.0, (3, 4))
    return (f"{name}-{mode}", lambda ops: getattr(ops, name).from_onnx({}),
            [(a, _u(0.5, 2.0, (3, 4))), (b, divisor)], fns[name], 0.05 if name == "Div" else 0.01)


# (id, the module from the package's onnx_ops, inputs as (kind, spec) with
# kind "enc" (encrypted), "enc0" (encrypted at precision 0) or "pub", the
# float64 reference of the drawn inputs, tolerance; inputs are passed as a
# list, or alone where there is one and the id does not end in "[list]")
OP_CASES = [
    ("Identity", lambda ops: ops.Identity.from_onnx({}), [("enc", _n((3, 4)))], lambda x: x,
     1e-3),
    *[_binary(name, mode) for name in ("Add", "Sub", "Mul", "Div")
      for mode in ("enc_enc", "enc_pub", "pub_enc")],
    ("Pow", lambda ops: ops.Pow.from_onnx({}), [("enc", _u(0.3, 2.0, (8,))),
                                                 ("pub", ("c", np.array(2.0)))],
     lambda x, p: x ** 2, 0.02),
    # sqrt's haar LUT envelope: [4, 200] within 0.25 (test_functions.py)
    ("Sqrt", lambda ops: ops.Sqrt.from_onnx({}), [("enc", _u(4.0, 64.0, (8,)))], np.sqrt, 0.25),
    ("Exp", lambda ops: ops.Exp.from_onnx({}), [("enc", _u(0.3, 2.0, (8,)))], np.exp, 0.2),
    ("Erf", lambda ops: ops.Erf.from_onnx({}), [("enc", _u(-2.0, 2.0, (16,)))], _erf, 0.05),
    *[(f"Mean-keepdims{k}", lambda ops, k=k: ops.Mean.from_onnx({"axes": [1], "keepdims": k}),
       [("enc", _n((3, 4, 5)))], lambda x, k=k: x.mean(1, keepdims=bool(k)), 0.01)
      for k in (0, 1)],
    *[(f"Sum-keepdims{k}", lambda ops, k=k: ops.Sum.from_onnx({"axes": [0, 2], "keepdims": k}),
       [("enc", _n((3, 4, 5)))], lambda x, k=k: x.sum((0, 2), keepdims=bool(k)), 0.05)
      for k in (0, 1)],
    ("Transpose", lambda ops: ops.Transpose.from_onnx({"perm": [2, 0, 1]}),
     [("enc", _n((2, 3, 4)))], lambda x: x.transpose(2, 0, 1), 1e-3),
    *[(f"Squeeze-{i}", lambda ops, a=a: ops.Squeeze.from_onnx({"axes": a} if a else {}),
       [("enc", _n(shape))], lambda x, e=e: x.reshape(e), 1e-3)
      for i, (a, shape, e) in enumerate([([0], (1, 3, 4), (3, 4)), ([0, 2], (1, 3, 1, 4), (3, 4)),
                                         (None, (1, 3, 1), (3,))])],
    *[(f"Unsqueeze{a}", lambda ops, a=a: ops.Unsqueeze.from_onnx({"axes": [a]}),
       [("enc", _n((3, 4)))], lambda x, a=a: np.expand_dims(x, a), 1e-3) for a in (0, 2, -1)],
    *[(f"Slice-{i}", lambda ops, s=s, e=e, a=a: ops.Slice.from_onnx(
        {"starts": s, "ends": e, "axes": a}), [("enc", _n((4, 5)))],
       lambda x, s=s, e=e, a=a: _slice(x, s, e, a), 1e-3)
      for i, (s, e, a) in enumerate([([1], [3], [0]), ([0, 1], [2, 3], [0, 1]),
                                     ([-2], [2 ** 31], [1]), ([1], [-1], None)])],
    ("Slice-runtime[list]", lambda ops: ops.Slice(None, None),
     [("enc", _n((4, 5))), ("pub", ("c", np.array([0]))), ("pub", ("c", np.array([2]))),
      ("pub", ("c", np.array([1]))), ("pub", ("c", np.array([1])))], lambda x, *r: x[:, 0:2],
     1e-3),
    ("Expand", lambda ops: ops.Expand.from_onnx({}),
     [("enc", _n((3, 1))), ("pub", ("c", np.array([3, 4])))],
     lambda x, s: np.broadcast_to(x, (3, 4)), 1e-3),
    ("ConstantOfShape", lambda ops: ops.ConstantOfShape.from_onnx({"value": np.array([3.5])}),
     [("pub", ("c", np.array([2, 5])))], lambda s: np.full((2, 5), 3.5), 0),
    ("Shape", lambda ops: ops.Shape.from_onnx({}), [("enc", _n((2, 5)))],
     lambda x: np.array([2, 5]), 0),
    # a no-op on a private input; a public one (PlainTensor) cast to float32
    ("Cast", lambda ops: ops.Cast.from_onnx({"to": 1}), [("enc", _n((3,)))],
     lambda x: x.astype(np.float32), 1e-3),
    ("Range[list]", lambda ops: ops.Range.from_onnx({}),
     [("pub", ("c", np.array(1.0))), ("pub", ("c", np.array(7.0))),
      ("pub", ("c", np.array(2.0)))], lambda *r: np.array([1.0, 3.0, 5.0]), 0),
    ("Equal", lambda ops: ops.Equal.from_onnx({}),
     [("enc", ("c", np.array([1.0, 2.0, 3.0]))), ("enc", ("c", np.array([1.0, 5.0, 3.0])))],
     lambda a, b: (a == b) * 1.0, 0.01),
    ("Where", lambda ops: ops.Where.from_onnx({}),
     [("enc0", ("c", np.array([1.0, 0.0, 0.0, 1.0, 1.0, 0.0]))), ("enc", _n((6,))),
      ("enc", _n((6,)))], lambda c, a, b: np.where(c > 0, a, b), 0.01),
    ("Concat", lambda ops: ops.Concat.from_onnx({"axis": 1}),
     [("enc", _n((2, 3))), ("enc", _n((2, 2)))], lambda a, b: np.concatenate([a, b], 1), 1e-3),
    ("Reshape", lambda ops: ops.Reshape.from_onnx({}),
     [("enc", _n((2, 3))), ("pub", ("c", np.array([3, 2])))], lambda a, s: a.reshape(3, 2),
     1e-3),
    ("Gather", lambda ops: ops.Gather.from_onnx({"axis": 1}),
     [("enc", _n((2, 3))), ("pub", ("c", np.array([2, 0])))], lambda a, i: a[:, [2, 0]], 1e-3),
    ("ConstantPad1d", lambda ops: ops.ConstantPad1d(1, 0.0), [("enc", _n((2, 3)))],
     lambda x: np.pad(x, [(0, 0), (1, 1)]), 1e-3),
    ("ConstantPad2d", lambda ops: ops.ConstantPad2d((1, 0, 0, 2), 0.5), [("enc", _n((1, 2, 3)))],
     lambda x: np.pad(x, [(0, 0), (0, 2), (1, 0)], constant_values=0.5), 1e-3),
    ("ConstantPad3d", lambda ops: ops.ConstantPad3d(1, 0.0), [("enc", _n((1, 2, 2, 2)))],
     lambda x: np.pad(x, [(0, 0), (1, 1), (1, 1), (1, 1)]), 1e-3),
    ("Pad-runtime", lambda ops: ops.ConstantPad2d.from_onnx({"mode": b"constant"}),
     [("enc", _n((2, 3))), ("pub", ("c", np.array([1, 0, 1, 0])))],
     lambda x, p: np.pad(x, [(1, 0), (1, 0)]), 1e-3),
    *[(f"Gemm-transA{ta}-transB{tb}", lambda ops, ta=ta, tb=tb: ops.Gemm.from_onnx(
        {"alpha": 0.5, "beta": 2.0, "transA": ta, "transB": tb}),
       [("enc", _n((4, 3) if ta else (3, 4))), ("enc", _n((2, 4) if tb else (4, 2))),
        ("enc", _n((3, 2)))],
       lambda a, b, c, ta=ta, tb=tb: 0.5 * (a.T if ta else a) @ (b.T if tb else b) + 2.0 * c,
       0.02) for ta in (0, 1) for tb in (0, 1)],
    ("Gemm-pub_enc", lambda ops: ops.Gemm.from_onnx({}),
     [("pub", _n((3, 4))), ("enc", _n((4, 2))), ("enc", _n((2,)))], lambda a, b, c: a @ b + c,
     0.02),
    ("Gemm-enc_pub", lambda ops: ops.Gemm.from_onnx({}),
     [("enc", _n((3, 4))), ("pub", _n((4, 2))), ("pub", _n((2,)))], lambda a, b, c: a @ b + c,
     0.02),
    *[(f"MatMul-{mode}", lambda ops: ops.MatMul.from_onnx({}),
       [(mode.split("_")[0], _n((2, 3, 4))), (mode.split("_")[1], _n((2, 4, 5)))],
       lambda a, b: a @ b, 0.02) for mode in ("enc_enc", "enc_pub", "pub_enc")],
    *[(f"Conv-bias{b}", lambda ops: ops.Conv.from_onnx(
        {"strides": [2, 2], "pads": [1, 1, 1, 1], "dilations": [1, 1]}),
       [("enc", _n((1, 2, 6, 6))), ("enc", _n((3, 2, 3, 3), 0.3))] + (
           [("enc", _n((3,)))] if b else []),
       lambda x, w, *bias: _conv(x, w, *bias, stride=2, padding=1), 0.05) for b in (0, 1)],
    ("Conv1d", lambda ops: ops.Conv.from_onnx({"strides": [1], "pads": [0, 0]}),
     [("enc", _n((1, 2, 8))), ("enc", _n((4, 2, 3), 0.3))], lambda x, w: _conv(x, w), 0.05),
    *[(name, lambda ops, name=name: getattr(ops, name).from_onnx({"ratio": 0.5}),
       [("enc", _n((2, 4, 3, 3) if name == "Dropout2d" else (2, 2, 2, 3, 3)))], lambda x: x,
       0.01) for name in ("Dropout2d", "Dropout3d")],
    ("GlobalAveragePool", lambda ops: ops.GlobalAveragePool.from_onnx({}),
     [("enc", _n((2, 3, 4, 5)))], lambda x: x.mean((2, 3), keepdims=True), 0.01),
    ("AdaptiveAvgPool2d", lambda ops: ops.AdaptiveAvgPool2d.from_onnx({"shape": [3, 3]}),
     [("enc", _n((1, 2, 6, 6)))],
     lambda x: F.adaptive_avg_pool2d(torch.as_tensor(x), (3, 3)).numpy(), 0.02),
    ("AdaptiveMaxPool2d", lambda ops: ops.AdaptiveMaxPool2d.from_onnx({"shape": [2, 2]}),
     [("enc", _n((1, 2, 6, 6)))],
     lambda x: F.adaptive_max_pool2d(torch.as_tensor(x), (2, 2)).numpy(), 0.05),
    ("AveragePool", lambda ops: ops._Pool2d.from_onnx(
        "average", {"kernel_shape": [2, 2], "strides": [2, 2]}), [("enc", _n((1, 2, 6, 6)))],
     lambda x: _pool("avg", x, 2, 2), 0.02),
    ("MaxPool", lambda ops: ops._Pool2d.from_onnx(
        "max", {"kernel_shape": [3, 3], "strides": [1, 1], "pads": [1, 1, 1, 1]}),
     [("enc", _n((1, 2, 6, 6)))], lambda x: _pool("max", x, 3, 1, 1), 0.05),
    # encrypted running statistics normalize by the private inv_sqrt; its
    # variances in [4, 16], where its cells are accurate to about 3%
    ("BatchNormalization", lambda ops: ops.BatchNormalization.from_onnx({"epsilon": 1e-5}),
     [("enc", _n((4, 3))), ("enc", _u(0.5, 1.5, (3,))), ("enc", _n((3,))),
      ("enc", _n((3,), 0.1)), ("enc", _u(4.0, 16.0, (3,)))], _bn, 0.2),
    ("LayerNormalization", lambda ops: ops.LayerNormalization.from_onnx({"epsilon": 1e-5}),
     [("enc", _n((2, 6), 2.0)), ("enc", _u(0.5, 1.5, (6,))), ("enc", _n((6,)))], _ln, 0.2),
    ("SILU", lambda ops: ops.SILU.from_onnx({}), [("enc", _n((8,)))],
     lambda x: x / (1 + np.exp(-x)), 0.06),
]
OP_IDS = [c[0] for c in OP_CASES]
# cases whose output is a public value, not a decoded share
PUBLIC_OUTPUT = {"ConstantOfShape", "Shape", "Range[list]"}
# the max pool with padding compared at 64-bit compares, where curl_tpu's
# pad of -2^24 is ordered (ROADMAP Queue C; the port pads with -2^(w-2))
OP_CONFIG = {"MaxPool": {"mpc.compare_bits": 64}}


def op_inputs(case):
    """The case's inputs drawn from its own numpy seed: [(kind, array)]."""
    rng = np.random.default_rng(77 + OP_IDS.index(case[0]))
    return [(kind, spec[1] if spec[0] == "c" else _draw(rng, spec)) for kind, spec in case[2]]


def run_op(pkg, ops, case, plain=False):
    """(decoded output, rounds, bytes) of the case's module in ``pkg``
    (``ops`` its onnx_ops), each input encrypted by its kind, or every
    input a PlainTensor (the port only)."""
    from curl_tpu_torch import comm

    name, make, _, _, _ = case
    module = make(ops)
    module.eval()
    vals = []
    for kind, a in op_inputs(case):
        if plain:
            vals.append(wrap_plain(a))
        elif kind == "pub":
            vals.append(a)
        else:
            vals.append(pkg.cryptensor(a, **({"precision": 0} if kind == "enc0" else {})))
    counts = comm if pkg is ct else _jax_comm()
    with pkg.cfg.temp_override(OP_CONFIG.get(name, {})):
        counts.reset_communication_stats()
        out = module(vals if len(vals) != 1 or name.endswith("[list]") else vals[0])
        stats = counts.get_communication_stats()
    out = unwrap_plain(out) if plain else _decoded(out)
    return np.asarray(out, dtype=np.float64), stats["rounds"], stats["bytes"]


def op_reference(case):
    return np.asarray(case[3](*[a for _, a in op_inputs(case)]), dtype=np.float64)


@pytest.mark.parametrize("case", OP_CASES, ids=OP_IDS)
def test_onnx_op_like_curl_tpu_and_float64(case, golden):
    _init()
    out, rounds, nbytes = run_op(ct, onnx_ops, case)
    ref, want = op_reference(case), golden[f"op/{case[0]}/output"]
    tol = case[4]
    assert out.shape == ref.shape == want.shape
    np.testing.assert_allclose(out, ref, atol=tol)
    np.testing.assert_allclose(out, want, atol=max(tol, 1e-3))
    assert (rounds, nbytes) == tuple(int(v) for v in golden[f"op/{case[0]}/counts"])


@pytest.mark.parametrize("case", OP_CASES, ids=OP_IDS)
def test_onnx_op_through_plain_tensor(case):
    _init()
    out, rounds, _ = run_op(ct, onnx_ops, case, plain=True)
    ref = op_reference(case)
    assert out.shape == ref.shape and rounds == 0
    np.testing.assert_allclose(out, ref, rtol=PLAIN_RTOL, atol=PLAIN_RTOL)


def test_constant_and_public_ops():
    """Constant holds a public value on the session's device; Cast of a
    public value changes its dtype; Equal of mismatched shapes is False; a
    private Gather index raises; asymmetric pads and reflect padding
    raise."""
    _init()
    c = onnx_ops.Constant.from_onnx({"value": np.arange(4.0)})
    np.testing.assert_array_equal(c().numpy(), np.arange(4.0))
    cast = onnx_ops.Cast.from_onnx({"to": 1})
    assert cast(np.arange(3).astype(np.int64)).dtype == torch.float32
    eq = onnx_ops.Equal.from_onnx({})
    assert eq([ct.cryptensor(np.ones(3)), ct.cryptensor(np.ones(2))]) is False
    with pytest.raises(ValueError):
        onnx_ops.Gather.from_onnx({"axis": 0})([ct.cryptensor(np.ones(4)),
                                                ct.cryptensor(np.array([1.0]), precision=0)])
    with pytest.raises(NotImplementedError):
        onnx_ops.Conv.from_onnx({"pads": [1, 0, 0, 0]})
    with pytest.raises(AssertionError):
        onnx_ops._ConstantPad.from_onnx({"mode": b"reflect"})
    with pytest.raises(ValueError):
        onnx_ops.Slice(None, None)([ct.cryptensor(np.ones((4, 5))), np.array([0]), np.array([2]),
                                    np.array([1]), np.array([2])])


def test_dropout_nd_in_training_drops_whole_channels():
    _init()
    d = onnx_ops.Dropout2d.from_onnx({"ratio": 0.5})
    d.train()
    out = d(ct.cryptensor(np.ones((2, 8, 3, 3)))).get_plain_text().reshape(2, 8, -1)
    zeroed = np.isclose(out, 0, atol=0.01).all(-1)
    scaled = np.isclose(out, 2.0, atol=0.05).all(-1)
    assert np.logical_or(zeroed, scaled).all()


# ---------------------------------------------------------------------------
# the containers
# ---------------------------------------------------------------------------

def test_graph_diamond_multi_output_and_names_with_dots():
    _init()
    g = ct.nn.Graph(["x"], ["out"])
    g.add_module("sq.0", onnx_ops.Mul.from_onnx({}), ["x", "x"])
    g.add_module("neg", onnx_ops.Sub.from_onnx({}), ["sq.0", "x"])
    g.add_module("training", onnx_ops.Identity(), ["neg"])  # a Module attribute's name
    g.add_module("out", onnx_ops.Add.from_onnx({}), ["sq.0", "training"])
    assert isinstance(g, onnx_ops.Container) and not isinstance(g.node("neg"), onnx_ops.Container)
    assert isinstance(g.node("sq.0"), onnx_ops.Mul) and "sq__0" in dict(g.named_children())
    x = np.random.default_rng(1).uniform(0.2, 1.0, size=(5,))
    np.testing.assert_allclose(g(ct.cryptensor(x)).get_plain_text(), 2 * x * x - x, atol=0.02)
    np.testing.assert_allclose(unwrap_plain(g(x)), 2 * x * x - x, rtol=1e-12)
    with pytest.raises(AssertionError):
        g.add_module("neg", onnx_ops.Identity(), ["x"])

    class SplitHalves(ct.nn.Module):
        def forward(self, x):
            n = x.size(0)
            return x.narrow(0, 0, n // 2), x.narrow(0, n // 2, n - n // 2)

    g2 = ct.nn.Graph(["x"], ["y"])
    g2.add_module("split", SplitHalves(), ["x"], output_names=["lo", "hi"])
    g2.add_module("y", onnx_ops.Add.from_onnx({}), ["lo", "hi"])
    x = np.random.default_rng(2).normal(size=(6,))
    np.testing.assert_allclose(g2(ct.cryptensor(x)).get_plain_text(), x[:3] + x[3:], atol=0.01)
    g3 = ct.nn.Graph(["x"], ["out"])
    g3.add_module("out", onnx_ops.Add.from_onnx({}), ["x", "missing"])
    with pytest.raises(ValueError):
        g3(ct.cryptensor(np.ones(3)))


def test_graph_encrypt_decrypt_and_parameter():
    """encrypt reaches every node's parameters; ``Parameter`` registers a
    float64 tensor; decrypt restores them."""
    _init()
    g = ct.nn.Graph(["x"], ["lin"])
    lin = ct.nn.Linear(4, 2)
    g.add_module("lin", lin, ["x"])
    g.encrypt(src=0)
    assert ct.is_encrypted_tensor(lin.weight)
    out = g(ct.cryptensor(np.random.default_rng(3).normal(size=(3, 4)))).get_plain_text()
    assert out.shape == (3, 2)
    g.decrypt()
    assert isinstance(lin.weight, torch.Tensor)
    m = ct.nn.Module()
    m.w = ct.nn.Parameter(np.ones((2, 2), dtype=np.float32))
    assert m.w.dtype == torch.float64 and dict(m.named_parameters())["w"] is m.w
    m.encrypt()
    assert ct.is_encrypted_tensor(m.w)


def test_module_list_and_dict():
    ml = onnx_ops.ModuleList([ct.nn.ReLU(), ct.nn.Sigmoid()])
    assert len(ml) == 2 and isinstance(ml[0], ct.nn.ReLU)
    assert isinstance(ml[0:1], onnx_ops.ModuleList)
    ml.append(ct.nn.Tanh())
    assert len(list(iter(ml))) == 3
    md = onnx_ops.ModuleDict({"a": ct.nn.ReLU()})
    md["b"] = ct.nn.Tanh()
    assert "a" in md and "b" in md and set(md.keys()) == {"a", "b"}
    with pytest.raises(NotImplementedError):
        ml(1)
    with pytest.raises(NotImplementedError):
        md(1)


# ---------------------------------------------------------------------------
# onnx_lite, from_onnx from a file, graph_to_dot, where
# ---------------------------------------------------------------------------

def test_onnx_lite_parses_initializers_and_attributes():
    torch.manual_seed(0)
    net = torch.nn.Linear(3, 2)
    data = export_onnx_bytes(net, torch.randn(1, 3))
    g = onnx_lite.load_model(data).graph
    assert len(g.outputs) == 1
    gemm = [n for n in g.nodes if n.op_type == "Gemm"]
    assert gemm and set(gemm[0].attributes) >= {"alpha", "beta"}
    assert gemm[0].attributes["transB"] == 1
    weights = [t.array for t in g.initializers if t.array.shape == (2, 3)]
    np.testing.assert_array_equal(weights[0], net.weight.detach().numpy())
    # a float64 export's initializers arrive as doubles
    g64 = onnx_lite.load_model(export_onnx_bytes(net.double(), torch.randn(1, 3).double())).graph
    assert all(t.array.dtype == np.float64 for t in g64.initializers)


def test_from_onnx_file_path(tmp_path, golden):
    _init()
    path = tmp_path / "m.onnx"
    path.write_bytes(golden[onnx_key("mlp", "onnx")].tobytes())
    graph = ct.nn.from_onnx(str(path))
    x = model_input("mlp")
    with open(path, "rb") as f:
        np.testing.assert_allclose(unwrap_plain(ct.nn.from_onnx(f)(x)), torch_reference("mlp"),
                                   rtol=PLAIN_RTOL)
    graph.encrypt()
    np.testing.assert_allclose(graph(ct.cryptensor(x)).get_plain_text(), torch_reference("mlp"),
                               atol=ATOL)
    # a graph of one module is that module
    net = torch.nn.Flatten()
    single = ct.nn.from_onnx(export_onnx_bytes(net, torch.ones(1, 2, 3)))
    assert isinstance(single, ct.nn.Flatten)


def test_graph_to_dot(tmp_path):
    """One DOT node a module, each joined to its parent; parameter holders
    as boxes; the SummaryWriter writes the text."""
    model = ct.nn.from_pytorch(torch_model("residual"))
    dot = graph_to_dot(model, "residual")
    modules = list(model.named_modules())
    assert dot.count(" [label=") == len(modules)
    assert dot.count(" -> ") == len(modules) - 1
    assert "layer1__0__conv1 [label=\"layer1__0__conv1\\nConv2d\", shape=box]" in dot
    assert "root -> relu;" in dot
    path = SummaryWriter(str(tmp_path)).add_graph(model, "residual")
    assert open(path).read() == dot


def test_where():
    """Private condition (two products), public condition with private or
    public operands, and all public (torch.where)."""
    _init()
    rng = np.random.default_rng(9)
    a, b = rng.normal(size=6), rng.normal(size=6)
    cond = (a > b).astype(np.float64)
    want = np.where(cond > 0, a, b)
    ae, be = ct.cryptensor(a), ct.cryptensor(b)
    ce = ct.cryptensor(cond, precision=0)
    for c, x, y in ((ce, ae, be), (cond, ae, be), (cond, ae, b), (cond, a, be)):
        np.testing.assert_allclose(ct.where(c, x, y).get_plain_text(), want, atol=0.01)
    got = ct.where(cond, torch.as_tensor(a), torch.as_tensor(b))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_tensor_surface():
    _init()
    x = np.random.default_rng(4).normal(size=(2, 3, 4, 4))
    p = PlainTensor(x)
    assert p.shape == (2, 3, 4, 4) and p.dim() == 4 and p.v.dtype == torch.float64
    np.testing.assert_allclose(np.asarray(p.max_pool2d(2)), _pool("max", x, 2, 2))
    np.testing.assert_allclose(np.asarray(p.avg_pool2d(3, stride=1, padding=1)),
                               _pool("avg", x, 3, 1, 1))
    np.testing.assert_allclose(p.adaptive_avg_pool2d((1, 1)).get_plain_text(),
                               x.mean((2, 3), keepdims=True))
    np.testing.assert_allclose(p.softmax(-1).get_plain_text().sum(-1), 1.0)
    assert wrap_plain(p) is p and wrap_plain("s") == "s"
    assert unwrap_plain((p, 1))[1] == 1
