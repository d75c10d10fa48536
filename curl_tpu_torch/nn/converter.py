"""Bring your own model: a torch model or ONNX bytes as an encryptable
module of the port (counterpart of ``curl_tpu/nn/converter.py``; the
reference's curl/nn/onnx_converter.py:42-66).

``from_pytorch`` converts a ``torch.nn.Sequential`` of leaf modules
structurally, and any other model by a ``torch.fx`` symbolic trace into a
``GraphModule``: each leaf module mapped onto the port's module of the same
kind (``_convert_leaf_module``), each function and method of the traced
graph onto the MPCTensor op it names (``_fn_table``), so that torch never
dispatches an MPCTensor. A leaf module with no counterpart is skipped and
fails where the graph calls it.

``from_onnx`` reads the ONNX protobuf with ``utils/onnx_lite`` (no ``onnx``
package) and builds a ``Graph`` of ``onnx_ops`` modules, every initializer
a parameter node; a graph of one module is that module.

Converted weights are copied to the host as float64 tensors, as the port's
modules hold plaintext parameters until ``encrypt``.
"""

from __future__ import annotations

import operator
from typing import Any, Dict

import numpy as np
import torch
import torch.fx

from .. import comm, ring
from ..mpc.mpc import MPCTensor
from . import module as nn_mod
from .module import Module, skip_init
from .plain import PlainTensor, wrap_plain


def _host64(t):
    """A torch tensor copied to the host as a float64 tensor."""
    return t.detach().to(device="cpu", dtype=torch.float64)


class _AdaptiveAvgPool2d(Module):
    """torch's AdaptiveAvgPool2d (converter.py:93-99)."""

    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return x.adaptive_avg_pool2d(self.output_size)


class _Identity(Module):
    def forward(self, x):
        return x


def _with_weights(m, tm, names=("weight", "bias")):
    """``m`` with torch module ``tm``'s parameters ``names`` (those it has)."""
    for name in names:
        p = getattr(tm, name, None)
        if p is not None:
            m._params[name] = _host64(p)
        else:
            m._params.pop(name, None)
    return m


def _convert_leaf_module(tm):
    """A torch.nn leaf module as the port's module of the same kind
    (converter.py:32-124); NotImplementedError for any other."""
    t = type(tm).__name__
    with skip_init():
        if t == "Linear":
            return _with_weights(nn_mod.Linear(tm.in_features, tm.out_features,
                                               bias=tm.bias is not None), tm)
        if t in ("Conv1d", "Conv2d"):
            m = getattr(nn_mod, t)(
                tm.in_channels, tm.out_channels, tm.kernel_size, stride=tm.stride,
                padding=tm.padding if not isinstance(tm.padding, str) else 0,
                dilation=tm.dilation, groups=tm.groups, bias=tm.bias is not None)
            return _with_weights(m, tm)
        if t in ("BatchNorm1d", "BatchNorm2d", "BatchNorm3d"):
            m = _with_weights(getattr(nn_mod, t)(tm.num_features, eps=tm.eps,
                                                 momentum=tm.momentum or 0.1), tm)
            m.running_mean = _host64(tm.running_mean)
            m.running_var = _host64(tm.running_var)
            return m
        if t == "LayerNorm":
            return _with_weights(nn_mod.LayerNorm(tuple(tm.normalized_shape), eps=tm.eps), tm)
        if t == "Embedding":
            return _with_weights(nn_mod.Embedding(tm.num_embeddings, tm.embedding_dim), tm,
                                 names=("weight",))
    simple = {"ReLU": nn_mod.ReLU, "ReLU6": nn_mod.ReLU6, "GELU": nn_mod.GELU,
              "SiLU": nn_mod.SiLU, "Sigmoid": nn_mod.Sigmoid, "Tanh": nn_mod.Tanh,
              "Identity": _Identity}
    if t in simple:
        return simple[t]()
    if t == "Hardtanh":
        return nn_mod.Hardtanh(tm.min_val, tm.max_val)
    if t in ("Softmax", "LogSoftmax"):
        return getattr(nn_mod, t)(tm.dim if tm.dim is not None else -1)
    if t == "Dropout":
        return nn_mod.Dropout(tm.p)
    if t == "Flatten":
        return nn_mod.Flatten(tm.start_dim, tm.end_dim)
    if t in ("MaxPool2d", "AvgPool2d"):
        return getattr(nn_mod, t)(tm.kernel_size, stride=tm.stride, padding=tm.padding)
    if t == "AdaptiveAvgPool2d":
        return _AdaptiveAvgPool2d(tm.output_size)
    raise NotImplementedError(f"cannot convert torch module {t}")


def _receiver(x):
    """Whether ``x`` computes an op by its own method: private, or a
    PlainTensor of a graph run in the clear (not a public torch tensor,
    which would dispatch an MPCTensor operand to torch)."""
    return isinstance(x, (MPCTensor, PlainTensor))


def _add(a, b):
    if _receiver(a):
        return a.add(b)
    return b.add(a) if _receiver(b) else a + b


def _sub(a, b):
    if _receiver(a):
        return a.sub(b)
    return b.neg().add(a) if _receiver(b) else a - b


def _mul(a, b):
    if _receiver(a):
        return a.mul(b)
    return b.mul(a) if _receiver(b) else a * b


def _fn_table():
    """fx's call_function targets -> the port's ops (converter.py:127-160)."""
    F = torch.nn.functional
    return {
        operator.add: _add,
        torch.add: _add,
        operator.sub: _sub,
        torch.sub: _sub,
        operator.mul: _mul,
        torch.mul: _mul,
        operator.truediv: lambda a, b: a.div(b),
        torch.matmul: lambda a, b: a.matmul(b),
        torch.flatten: lambda a, s=0, e=-1: a.flatten(s, e),
        torch.relu: lambda a: a.relu(),
        F.relu: lambda a, inplace=False: a.relu(),
        F.gelu: lambda a, approximate="none": a.gelu(),
        F.silu: lambda a, inplace=False: a.silu(),
        torch.sigmoid: lambda a: a.sigmoid(),
        torch.tanh: lambda a: a.tanh(),
        F.softmax: lambda a, dim=-1, **kw: a.softmax(dim),
        F.log_softmax: lambda a, dim=-1, **kw: a.log_softmax(dim),
        F.dropout: lambda a, p=0.5, training=False, inplace=False: a.dropout(
            p=p, training=training),
        F.max_pool2d: lambda a, k, stride=None, padding=0, **kw: a.max_pool2d(
            k, stride=stride, padding=padding),
        F.avg_pool2d: lambda a, k, stride=None, padding=0, **kw: a.avg_pool2d(
            k, stride=stride, padding=padding),
    }


class GraphModule(Module):
    """A converted torch.fx graph, run node by node on the port's tensors.

    The traced graph's module targets hold ``.`` (``layer1.0.conv1``), which
    torch refuses in a submodule's name: each converted module is kept under
    its target with ``.`` as ``__`` (converter.py:166-170). An unencrypted
    input runs the graph in the clear through ``PlainTensor``."""

    def __init__(self, fx_graph, converted_modules, attrs):
        super().__init__()
        self.graph = fx_graph
        self._converted_names = {}
        for name, m in converted_modules.items():
            self._converted_names[name] = name.replace(".", "__")
            self.add_module(self._converted_names[name], m)
        self._attrs = attrs

    def forward(self, *inputs):
        import curl_tpu_torch

        if not any(isinstance(a, MPCTensor) for a in inputs):
            inputs = tuple(wrap_plain(a) for a in inputs)
        fn_table = _fn_table()
        env: Dict[str, Any] = {}
        input_iter = iter(inputs)
        out = None
        for node in self.graph.nodes:
            if node.op == "placeholder":
                env[node.name] = next(input_iter)
            elif node.op == "get_attr":
                env[node.name] = ring.host_constant(self._attrs[node.target], comm.get_device())
            elif node.op == "call_module":
                sub = self._modules[self._converted_names[node.target]]
                env[node.name] = sub(*[self._resolve(a, env) for a in node.args])
            elif node.op == "call_function":
                args = [self._resolve(a, env) for a in node.args]
                kwargs = {k: self._resolve(v, env) for k, v in node.kwargs.items()}
                if node.target in (torch.cat, torch.stack):
                    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
                    op = curl_tpu_torch.cat if node.target is torch.cat else curl_tpu_torch.stack
                    env[node.name] = op(list(args[0]), dim=dim)
                elif node.target in fn_table:
                    env[node.name] = fn_table[node.target](*args, **kwargs)
                elif node.target is getattr:
                    env[node.name] = getattr(*args)
                else:
                    raise NotImplementedError(f"cannot convert function {node.target}")
            elif node.op == "call_method":
                args = [self._resolve(a, env) for a in node.args]
                kwargs = {k: self._resolve(v, env) for k, v in node.kwargs.items()}
                obj, name = args[0], node.target
                if name == "size":
                    env[node.name] = obj.size(*args[1:])
                elif name in ("view", "reshape"):
                    env[node.name] = obj.view(*args[1:])
                elif hasattr(obj, name):
                    env[node.name] = getattr(obj, name)(*args[1:], **kwargs)
                else:
                    raise NotImplementedError(f"cannot convert method {name}")
            elif node.op == "output":
                out = self._resolve(node.args[0], env)
        return out

    def _resolve(self, arg, env):
        if isinstance(arg, torch.fx.Node):
            return env[arg.name]
        if isinstance(arg, (list, tuple)):
            return type(arg)(self._resolve(a, env) for a in arg)
        return arg


def from_pytorch(model, dummy_input=None):
    """A torch.nn model as an encryptable module of the port
    (converter.py:239-285): a Sequential of convertible leaf modules as a
    ``Sequential``, any other model through a torch.fx trace as a
    ``GraphModule``. The model is put in eval mode."""
    model = model.eval()

    if isinstance(model, torch.nn.Sequential):
        try:
            return nn_mod.Sequential(*[_convert_leaf_module(m) for m in model])
        except NotImplementedError:
            pass

    try:
        traced = torch.fx.symbolic_trace(model)
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(f"torch.fx could not trace model for conversion: {e}") from e

    converted = {}
    for name, sub in traced.named_modules():
        if name and not list(sub.children()):
            try:
                converted[name] = _convert_leaf_module(sub)
            except NotImplementedError:
                pass  # maybe unused: the graph fails where it calls it

    attrs = {}
    for node in traced.graph.nodes:
        if node.op == "get_attr":
            obj = traced
            for part in node.target.split("."):
                obj = getattr(obj, part)
            attrs[node.target] = _host64(obj).numpy()

    return GraphModule(traced.graph, converted, attrs)


class _OnnxParameter(Module):
    """A graph node holding one initializer (the reference adds a
    Parameter node for each, onnx_converter.py:175-177), encrypted with
    the graph's other parameters."""

    def __init__(self, value):
        super().__init__()
        self.register_param("data", torch.from_numpy(np.array(value, dtype=np.float64)))

    def forward(self, _input=None):
        return self._params["data"]


def _onnx_op_class(op_type, attributes):
    """ONNX op_type -> the port's module constructor (onnx_converter.py:
    150-161, 252-258)."""
    from . import onnx_ops

    # names that differ between ONNX and the module surface
    renamed = {
        "AveragePool": lambda a: onnx_ops._Pool2d.from_onnx("average", a),
        "MaxPool": lambda a: onnx_ops._Pool2d.from_onnx("max", a),
        "Pad": onnx_ops._ConstantPad.from_onnx,
        "ReduceMean": onnx_ops.Mean.from_onnx,
        "ReduceSum": onnx_ops.Sum.from_onnx,
        "Relu": lambda a: nn_mod.ReLU(),
        "Sigmoid": lambda a: nn_mod.Sigmoid(),
        "Tanh": lambda a: nn_mod.Tanh(),
        "Gelu": lambda a: nn_mod.GELU(),
        "Softmax": lambda a: nn_mod.Softmax((a or {}).get("axis", -1)),
        "LogSoftmax": lambda a: nn_mod.LogSoftmax((a or {}).get("axis", -1)),
        "Flatten": lambda a: nn_mod.Flatten((a or {}).get("axis", 1)),
        "Dropout": lambda a: nn_mod.Dropout((a or {}).get("ratio", 0.5)),
        "Clip": lambda a: nn_mod.Hardtanh((a or {}).get("min", -1.0), (a or {}).get("max", 1.0)),
    }
    if op_type in renamed:
        return lambda attributes=None: renamed[op_type](attributes)
    cls = getattr(onnx_ops, op_type, None)
    if cls is not None and hasattr(cls, "from_onnx"):
        return cls.from_onnx
    raise ValueError(f"unsupported ONNX op {op_type}")


def from_onnx(onnx_string_or_file):
    """A serialized ONNX model (bytes, a path or a file object) as an
    encryptable ``Graph`` (onnx_converter.py:42-66)."""
    from ..utils import onnx_lite
    from .onnx_ops import Graph

    model = onnx_lite.load_model(onnx_string_or_file)
    graph = model.graph
    init_names = {t.name for t in graph.initializers}
    input_names = [n for n in graph.inputs if n not in init_names]
    assert len(graph.outputs) == 1, "only one output per model supported"

    g = Graph(input_names, graph.outputs[0])
    for tensor in graph.initializers:
        g.add_module(tensor.name, _OnnxParameter(tensor.array), [])
    for node in graph.nodes:
        module = _onnx_op_class(node.op_type, node.attributes)(attributes=node.attributes)
        outputs = list(node.outputs)
        if node.op_type == "Dropout":
            outputs = outputs[:1]  # not the mask
        g.add_module(outputs[0], module, list(node.inputs), output_names=outputs)
    # a graph of one module is that module (onnx_converter.py:221-229)
    if len(g._modules) == 1:
        return next(iter(g._modules.values()))
    return g


def from_tensorflow(*a, **k):
    raise NotImplementedError("tensorflow conversion is not supported")
