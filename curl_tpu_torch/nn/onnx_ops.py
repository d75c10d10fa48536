"""ONNX-style graph-op modules and the dataflow ``Graph`` container
(counterpart of ``curl_tpu/nn/onnx_ops.py``; the reference's
curl/nn/module.py:599-3136).

Every class the reference registers for its ONNX graph building exists
here with the same name, forward contract and ``from_onnx(attributes)``
constructor, as a ``torch.nn.Module`` of the port (``module.Module``). A
module's input is a private MPCTensor, a public torch tensor on the
session's device, or a ``PlainTensor`` when the graph runs in the clear.
``Graph`` walks ready nodes and frees each value once its last consumer has
run (module.py:607-761).

Graph node names are ONNX value names, which may hold ``.`` (``fc.weight``)
or clash with a Module attribute, and torch refuses such names for
submodules: ``Graph`` keeps each node's submodule under a key of its own
(``.`` as ``__``, made unique) and its dataflow under the node's own name.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .. import comm, ring
from ..mpc.mpc import MPCTensor
from .module import Module

_ONNX_DTYPES = {1: torch.float32, 6: torch.int32, 7: torch.int64, 11: torch.float64}


def _is_enc(x):
    return isinstance(x, MPCTensor)


def _host(v):
    """A public value on the host, as numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _public(v):
    """A public value as a torch tensor on the session's device (a
    PlainTensor's value as it is)."""
    v = getattr(v, "v", v)
    if isinstance(v, torch.Tensor):
        return v.to(comm.get_device())
    arr = np.asarray(v)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float64)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(comm.get_device())


def _as_int_list(v):
    if v is None:
        return None
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(x) for x in _host(v).reshape(-1).tolist()]


def _scalar_or_tuple(vals):
    """[v] -> v, [v1, v2, ...] -> (v1, v2, ...): per-dim values kept."""
    vals = list(vals)
    return vals[0] if len(vals) == 1 else tuple(vals)


def _onnx_symmetric_pads(pads):
    """ONNX pads [x1_begin, x2_begin, ..., x1_end, x2_end] -> per-dim
    values; the conv and pool kernels pad symmetrically, so asymmetric pads
    raise."""
    pads = _as_int_list(pads)
    if len(pads) % 2 == 0 and len(pads) > 1:
        half = len(pads) // 2
        begin, end = pads[:half], pads[half:]
        if begin != end:
            raise NotImplementedError(f"asymmetric ONNX pads {pads} are not supported")
        return begin
    return pads


def _registered(name, x, *args, **kwargs):
    """A function of ``gradients.py`` on ``x``: an MPCTensor's method (on
    the tape where an operand requires grad), a PlainTensor through the
    function's forward."""
    if _is_enc(x):
        return getattr(x, name)(*args, **kwargs)
    from ..autograd import FUNCTION_REGISTRY, AutogradContext

    return FUNCTION_REGISTRY[name].forward(AutogradContext(), x, *args, **kwargs)


# ---------------------------------------------------------------------------
# containers (reference module.py:599-930)
# ---------------------------------------------------------------------------

class Container(Module):
    """Marker distinguishing containers from leaf modules."""


class Graph(Container):
    """Acyclic dataflow graph of named modules (reference module.py:607).

    ``_graph[name]`` lists the value names feeding node ``name``; a module
    may declare several outputs by ``_output_names``. ``forward`` walks the
    ready nodes and frees the values whose consumers have all run."""

    def __init__(self, input_names, output_names, modules=None, graph=None):
        super().__init__()
        if not isinstance(input_names, (list, tuple)):
            input_names = [input_names]
        if not isinstance(output_names, (list, tuple)):
            output_names = [output_names]
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        self._graph = dict(graph) if graph else {}
        self._nodes = OrderedDict()  # node name -> its key in _modules
        for name, module in (modules or {}).items():
            self._register_node(name, module)

    def _register_node(self, name, module):
        key = str(name).replace(".", "__") or "node"
        base, n = key, 0
        while key in self._modules or (hasattr(self, key) and key not in self._modules):
            n += 1
            key = f"{base}_{n}"
        torch.nn.Module.add_module(self, key, module)
        self._nodes[name] = key

    def add_module(self, name, module, input_names=None, output_names=None):
        assert name not in self._nodes, f"module {name} already exists"
        self._register_node(name, module)
        if input_names is not None:
            self._graph[name] = list(input_names)
        if output_names is not None:
            module._output_names = list(output_names)

    def node(self, name):
        """The module of graph node ``name``."""
        return self._modules[self._nodes[name]]

    def forward(self, *args):
        assert len(args) == len(self.input_names), (
            f"expected {len(self.input_names)} inputs, got {len(args)}")
        # unencrypted inputs run through the same modules as PlainTensors
        plain_mode = not any(_is_enc(a) for a in args)
        if plain_mode:
            from .plain import wrap_plain

            args = tuple(wrap_plain(a) for a in args)
        values = dict(zip(self.input_names, args))

        # remaining-consumer counts, to free dead values
        consumers = {}
        for inputs in self._graph.values():
            for v in inputs:
                consumers[v] = consumers.get(v, 0) + 1
        for o in self.output_names:
            consumers[o] = consumers.get(o, 0) + 1

        done = set()

        def ready(node):
            return node not in done and all(v in values for v in self._graph.get(node, []))

        progress = True
        while progress:
            progress = False
            for node, key in self._nodes.items():
                if not ready(node):
                    continue
                module = self._modules[key]
                inputs = [values[v] for v in self._graph.get(node, [])]
                out = module(inputs if len(inputs) != 1 else inputs[0])
                if plain_mode:
                    out = (tuple(wrap_plain(o) for o in out) if isinstance(out, tuple)
                           else wrap_plain(out))
                outs = getattr(module, "_output_names", None) or [node]
                if len(outs) == 1:
                    values[outs[0]] = out
                else:
                    assert isinstance(out, tuple) and len(out) == len(outs)
                    values.update(zip(outs, out))
                done.add(node)
                progress = True
                for v in self._graph.get(node, []):
                    consumers[v] -= 1
                    if consumers.get(v) == 0 and v not in self.output_names:
                        values.pop(v, None)
                if all(o in values for o in self.output_names):
                    result = [values[o] for o in self.output_names]
                    return result[0] if len(result) == 1 else tuple(result)
        raise ValueError("nn.Graph.forward() failed: is the graph connected?")


class ModuleList(Module):
    """List container with registered submodules (reference module.py:794)."""

    def __init__(self, modules=None):
        super().__init__()
        if modules is not None:
            self.extend(modules)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return ModuleList(list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, module):
        self.add_module(str(len(self._modules)), module)
        return self

    def extend(self, modules):
        for m in modules:
            self.append(m)
        return self

    def forward(self, *a, **k):
        raise NotImplementedError("ModuleList has no forward")


class ModuleDict(Module):
    """Dict container with registered submodules (reference module.py:857)."""

    def __init__(self, modules=None):
        super().__init__()
        if modules is not None:
            self.update(modules)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, module):
        self.add_module(key, module)

    def __contains__(self, key):
        return key in self._modules

    def __iter__(self):
        return iter(self._modules)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, modules):
        for k, v in (modules.items() if hasattr(modules, "items") else modules):
            self.add_module(k, v)

    def forward(self, *a, **k):
        raise NotImplementedError("ModuleDict has no forward")


# ---------------------------------------------------------------------------
# stateless ONNX graph ops (reference module.py:964-1845)
# ---------------------------------------------------------------------------

class Identity(Module):
    """(reference module.py:964)"""

    def forward(self, x):
        return x

    @staticmethod
    def from_onnx(attributes=None):
        return Identity()


class Constant(Module):
    """A public constant, never encrypted (reference module.py:976): a
    float64 tensor, copied to the session's device once."""

    def __init__(self, value):
        super().__init__()
        self.value = np.asarray(_host(value), dtype=np.float64)

    def forward(self, _input=None):
        return ring.host_constant(self.value, comm.get_device())

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        assert "value" in attributes, "Constant needs a value"
        return Constant(attributes["value"])


class ConstantOfShape(Module):
    """A constant-filled tensor of a runtime shape (reference module.py:1009)."""

    def __init__(self, value):
        super().__init__()
        self.value = float(_host(value).reshape(-1)[0])

    def forward(self, size):
        return torch.full(tuple(_as_int_list(size)), self.value, dtype=torch.float64,
                          device=comm.get_device())

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        assert "value" in attributes, "ConstantOfShape needs a value"
        return ConstantOfShape(attributes["value"])


class _Binary(Module):
    """Two-input elementwise op (reference Add/Sub/Mul/Div, module.py:1046-1100)."""

    _METHOD = None

    def forward(self, x):
        assert isinstance(x, (list, tuple)) and len(x) == 2, f"{type(self).__name__} takes [a, b]"
        a, b = x
        if not _is_enc(a) and _is_enc(b):
            # a public first operand: through the private one
            return _SWAPPED[self._METHOD](b, a)
        return getattr(a, self._METHOD)(b)

    @classmethod
    def from_onnx(cls, attributes=None):
        return cls()


_SWAPPED = {
    "add": lambda b, a: b.add(a),
    "mul": lambda b, a: b.mul(a),
    "sub": lambda b, a: b.neg().add(a),
    "div": lambda b, a: b.reciprocal().mul(a),
}


class Add(_Binary):
    _METHOD = "add"


class Sub(_Binary):
    _METHOD = "sub"


class Mul(_Binary):
    _METHOD = "mul"


class Div(_Binary):
    _METHOD = "div"


class Pow(Module):
    """(reference module.py:1103)"""

    def forward(self, x):
        base, power = x
        p = _host(power).reshape(-1)
        if p.size == 1:
            power = float(p[0])
            if int(power) == power:
                power = int(power)
        return base.pow(power)

    @staticmethod
    def from_onnx(attributes=None):
        return Pow()


class Sqrt(Module):
    def forward(self, x):
        return x.sqrt()

    @staticmethod
    def from_onnx(attributes=None):
        return Sqrt()


class Exp(Module):
    def forward(self, x):
        return x.exp()

    @staticmethod
    def from_onnx(attributes=None):
        return Exp()


class Erf(Module):
    def forward(self, x):
        return x.erf()

    @staticmethod
    def from_onnx(attributes=None):
        return Erf()


class _Reduce(Module):
    """ReduceMean / ReduceSum (reference module.py:1160)."""

    def __init__(self, dim, keepdim=False, reduction_fn="mean"):
        super().__init__()
        self.dim = tuple(_as_int_list(dim)) if dim is not None else None
        self.keepdim = keepdim
        self.reduction_fn = reduction_fn

    def forward(self, x):
        dim = self.dim if self.dim is None or len(self.dim) > 1 else self.dim[0]
        return getattr(x, self.reduction_fn)(dim, keepdim=self.keepdim)


class Mean(_Reduce):
    def __init__(self, dim, keepdim=False):
        super().__init__(dim, keepdim, "mean")

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        return Mean(attributes["axes"], bool(attributes.get("keepdims", 1)))


class Sum(_Reduce):
    def __init__(self, dim, keepdim=False):
        super().__init__(dim, keepdim, "sum")

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        return Sum(attributes["axes"], bool(attributes.get("keepdims", 1)))


class Transpose(Module):
    """ONNX permutation (reference module.py:1219)."""

    def __init__(self, perm):
        super().__init__()
        self.perm = _as_int_list(perm)

    def forward(self, x):
        assert x.dim() == len(self.perm)
        return x.permute(*self.perm)

    @staticmethod
    def from_onnx(attributes=None):
        return Transpose((attributes or {})["perm"])


class Squeeze(Module):
    """(reference module.py:1254)"""

    def __init__(self, dimension):
        super().__init__()
        dims = _as_int_list(dimension)
        self.dimension = dims[0] if dims and len(dims) == 1 else dims

    def forward(self, x):
        dims = self.dimension
        if dims is None or isinstance(dims, int):
            return x.squeeze(dims) if dims is not None else x.squeeze()
        # several axes: from the highest, so that the others stay valid
        ndim = len(x.shape)
        for d in sorted((d % ndim for d in dims), reverse=True):
            x = x.squeeze(d)
        return x

    @staticmethod
    def from_onnx(attributes=None):
        return Squeeze((attributes or {}).get("axes"))


class Unsqueeze(Module):
    """(reference module.py:1294)"""

    def __init__(self, dimension=None):
        super().__init__()
        dims = _as_int_list(dimension)
        self.dimension = dims[0] if dims else None

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x, dim = x
            dim = _as_int_list(dim)[0]
        else:
            dim = self.dimension
        if _is_enc(x):
            return x.unsqueeze(dim)
        return _public(x).unsqueeze(dim)

    @staticmethod
    def from_onnx(attributes=None):
        dims = (attributes or {}).get("axes", [None])
        return Unsqueeze(dims[0])


class Slice(Module):
    """ONNX opset-11 slice by repeated narrow (reference module.py:1335)."""

    def __init__(self, starts, ends, axes=None):
        super().__init__()
        self.starts = starts
        self.ends = ends
        self.axes = axes

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            parts = list(x)
            axes = self.axes
            if len(parts) == 3:
                x, starts, ends = parts
            elif len(parts) == 4:
                x, starts, ends, axes = parts
            elif len(parts) == 5:
                x, starts, ends, axes, steps = parts
                if not np.all(_host(steps) == 1):
                    raise ValueError("only step 1 is supported")
            else:
                raise ValueError("Slice takes 3-5 inputs")
            starts, ends = _as_int_list(starts), _as_int_list(ends)
            axes = _as_int_list(axes)
        else:
            starts, ends, axes = (_as_int_list(self.starts), _as_int_list(self.ends),
                                  _as_int_list(self.axes))
        if axes is None:
            axes = list(range(len(starts)))
        out = x
        for start, end, axis in zip(starts, ends, axes):
            n = int(out.shape[axis])
            # ONNX: negative indices count from the end; ends clamp to n
            # (exporters write INT64_MAX and -INT64_MAX sentinels)
            start = max(start + n, 0) if start < 0 else min(start, n)
            end = max(end + n, 0) if end < 0 else min(end, n)
            out = out.narrow(int(axis), start, max(end - start, 0))
        return out

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        return Slice(attributes.get("starts"), attributes.get("ends"),
                     axes=attributes.get("axes"))


class Expand(Module):
    """(reference module.py:1389)"""

    def forward(self, x):
        inp, shape = x
        shape = _as_int_list(shape)
        # ONNX broadcasts target dims of 1 from the input
        for i in range(len(shape)):
            if shape[i] == 1 and inp.size(i) > 1:
                shape[i] = inp.size(i)
        return inp.expand(*shape)

    @staticmethod
    def from_onnx(attributes=None):
        return Expand()


class Cast(Module):
    """A no-op on encrypted tensors (reference module.py:1413)."""

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype

    def forward(self, x):
        if _is_enc(x):
            return x
        arr = _public(x)
        return arr.to(self.dtype) if self.dtype is not None else arr

    @staticmethod
    def from_onnx(attributes=None):
        to = (attributes or {}).get("to")
        return Cast(_ONNX_DTYPES.get(int(to)) if to is not None else None)


class Range(Module):
    """(reference module.py:1435)"""

    def forward(self, x):
        if len(x) == 2:
            start, end, step = x[0], x[1], 1
        elif len(x) == 3:
            start, end, step = x
        else:
            raise ValueError("Range takes 2 or 3 inputs")
        start, end, step = (float(_host(v).reshape(-1)[0]) for v in (start, end, step))
        return torch.arange(start, end, step, dtype=torch.float64, device=comm.get_device())

    @staticmethod
    def from_onnx(attributes=None):
        return Range()


class Equal(Module):
    """(reference module.py:1457)"""

    def forward(self, x):
        a, b = x
        if tuple(a.shape) != tuple(b.shape):
            return False
        return a.eq(b)

    @staticmethod
    def from_onnx(attributes=None):
        return Equal()


class Where(Module):
    """(reference module.py:1472)"""

    def forward(self, x):
        import curl_tpu_torch

        condition, a, b = x
        return curl_tpu_torch.where(condition, a, b)

    @staticmethod
    def from_onnx(attributes=None):
        return Where()


class Shape(Module):
    """The public shape vector (reference module.py:1529)."""

    def __init__(self, dim=None):
        super().__init__()
        self.dim = dim

    def forward(self, x, dim=None):
        dim = dim if dim is not None else self.dim
        shape = tuple(x.shape)
        value = list(shape) if dim is None else shape[dim]
        return torch.tensor(value, dtype=torch.int64, device=comm.get_device())

    @staticmethod
    def from_onnx(attributes=None):
        return Shape()


class Concat(Module):
    """(reference module.py:1553)"""

    def __init__(self, dimension):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        import curl_tpu_torch

        assert isinstance(x, (list, tuple)) and len(x) >= 1
        if not any(_is_enc(t) for t in x):
            return torch.cat([_public(t) for t in x], dim=self.dimension)
        return curl_tpu_torch.cat(list(x), self.dimension)

    @staticmethod
    def from_onnx(attributes=None):
        return Concat((attributes or {})["axis"])


class Reshape(Module):
    """(reference module.py:1573)"""

    def __init__(self, shape=None):
        super().__init__()
        self.shape = shape

    def forward(self, x, shape=None):
        if isinstance(x, (list, tuple)) and len(x) == 2:
            x, shape = x
        shape = shape if shape is not None else self.shape
        assert shape is not None, "Reshape needs a shape"
        shape = _as_int_list(shape)
        if _is_enc(x):
            return x.reshape(*shape)
        return _public(x).reshape(shape)

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        if "shape" in attributes:
            return Reshape(shape=attributes["shape"])
        return Reshape()


class Gather(Module):
    """Take along a dimension at public indices (reference module.py:1727)."""

    def __init__(self, dimension, indices=None):
        super().__init__()
        self.dimension = dimension
        self.indices = indices

    def forward(self, x):
        if not isinstance(x, (list, tuple)):
            tensor, indices = x, self.indices
        elif len(x) == 1:
            tensor, indices = x[0], self.indices
        else:
            tensor, indices = x
        if _is_enc(indices):
            raise ValueError("Gather needs public indices")
        indices = _host(indices).astype(np.int64)
        if _is_enc(tensor):
            return tensor.take(indices, self.dimension)
        t = _public(tensor)
        index = torch.from_numpy(indices).to(t.device)
        if self.dimension is None:
            return t.reshape(-1)[index]
        d = self.dimension % t.dim()
        return torch.index_select(t, d, index.reshape(-1)).reshape(
            t.shape[:d] + index.shape + t.shape[d + 1:])

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        # ONNX Gather's axis is optional with default 0 (not the flattened
        # take of dimension None)
        return Gather(attributes.get("axis", 0), indices=attributes.get("shape"))


class _ConstantPad(Module):
    """(reference module.py:1790)"""

    def __init__(self, padding, value, ndims, mode="constant"):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding, padding] * ndims
        self.padding = padding
        self.value = value
        self.mode = mode

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            assert len(x) == 2, "input should be [tensor, pads]"
            x, padding = x[0], _as_int_list(x[1])
        else:
            padding = self.padding
        return x.pad(tuple(padding), value=self.value)

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        mode = attributes.get("mode", b"constant")
        assert mode in (b"constant", "constant"), "only constant padding"
        return _ConstantPad(None, 0, 0, mode="constant")


class ConstantPad1d(_ConstantPad):
    def __init__(self, padding, value, mode="constant"):
        super().__init__(padding, value, 1, mode=mode)


class ConstantPad2d(_ConstantPad):
    def __init__(self, padding, value, mode="constant"):
        super().__init__(padding, value, 2, mode=mode)


class ConstantPad3d(_ConstantPad):
    def __init__(self, padding, value, mode="constant"):
        super().__init__(padding, value, 3, mode=mode)


def _t(v):
    """The transpose of a 2-D operand, private or public."""
    return v.t() if hasattr(v, "get_plain_text") else _public(v).t()


class Gemm(Module):
    """alpha * a @ b + beta * c (reference module.py:1845)."""

    def __init__(self, alpha=1.0, beta=1.0, trans_a=False, trans_b=False):
        super().__init__()
        self.alpha = alpha
        self.beta = beta
        self.trans_a = trans_a
        self.trans_b = trans_b

    def forward(self, x):
        a, b, c = x
        if self.trans_a:
            a = _t(a)
        if self.trans_b:
            b = _t(b)
        if hasattr(a, "get_plain_text"):  # private, or a PlainTensor
            out = a.matmul(b).mul(self.alpha)
        elif _is_enc(b):
            # public @ private as (b^T @ a^T)^T
            out = b.t().matmul(_public(a).t()).t().mul(self.alpha)
        else:
            out = _public(a) @ _public(b) * self.alpha
        cm = c.mul(self.beta) if hasattr(c, "get_plain_text") else _public(c) * self.beta
        return out.add(cm) if hasattr(out, "get_plain_text") else out + cm

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        return Gemm(alpha=attributes.get("alpha", 1.0), beta=attributes.get("beta", 1.0),
                    trans_a=bool(attributes.get("transA", 0)),
                    trans_b=bool(attributes.get("transB", 0)))


class MatMul(Module):
    """(reference module.py:1917)"""

    def __init__(self, weight=None):
        super().__init__()
        if weight is not None:
            self.register_param("weight", weight)

    def forward(self, x):
        if "weight" in self._params:
            return x.matmul(self._params["weight"])
        assert isinstance(x, (list, tuple)) and len(x) == 2
        a, b = x
        if not _is_enc(a) and _is_enc(b):
            # public @ private: transposed, through the private side
            return b.transpose(-2, -1).matmul(_public(a).transpose(-2, -1)).transpose(-2, -1)
        return a.matmul(b)

    @staticmethod
    def from_onnx(attributes=None):
        return MatMul()


def _unsqueeze_last(v):
    return v.unsqueeze(-1) if hasattr(v, "unsqueeze") else _public(v).unsqueeze(-1)


class Conv(Module):
    """Stateless ONNX Conv: input [x, weight(, bias)] (the reference's ONNX
    Conv node)."""

    def __init__(self, stride=1, padding=0, dilation=1, groups=1):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups

    def forward(self, x):
        if len(x) == 2:
            (inp, weight), bias = x, None
        else:
            inp, weight, bias = x
        # the kernel's rank decides 1-D or 2-D: (O, I, K) or (O, I, Kh, Kw)
        krank = len(weight.shape)
        conv_fn = "conv2d" if krank == 4 else "conv1d"
        out = getattr(inp, conv_fn)(weight, stride=self.stride, padding=self.padding,
                                    dilation=self.dilation, groups=self.groups)
        if bias is not None:
            for _ in range(krank - 2):
                bias = _unsqueeze_last(bias)
            out = out.add(bias)
        return out

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        strides = _as_int_list(attributes.get("strides", [1]))
        pads = _onnx_symmetric_pads(attributes.get("pads", [0]))
        dilations = _as_int_list(attributes.get("dilations", [1]))
        return Conv(stride=_scalar_or_tuple(strides), padding=_scalar_or_tuple(pads),
                    dilation=_scalar_or_tuple(dilations),
                    groups=int(attributes.get("group", 1)))


class DropoutNd(Module):
    """Channel dropout (reference module.py:1656)."""

    def __init__(self, p=0.5, inplace=False):
        super().__init__()
        self.p = p

    def forward(self, x):
        return _registered("_feature_dropout", x, self.p, self.training)

    @classmethod
    def from_onnx(cls, attributes=None):
        attributes = attributes or {}
        return cls(attributes.get("ratio", 0.5))


class Dropout2d(DropoutNd):
    pass


class Dropout3d(DropoutNd):
    pass


class GlobalAveragePool(Module):
    """(reference module.py:2878)"""

    def forward(self, x):
        assert x.dim() > 2, "needs more than two dimensions"
        out = x
        for dim in range(2, x.dim()):
            out = out.sum(dim, keepdim=True)
        return out.div(int(np.prod(tuple(x.shape)[2:])))

    @staticmethod
    def from_onnx(attributes=None):
        return GlobalAveragePool()


class AdaptiveAvgPool2d(Module):
    """(reference module.py:2774)"""

    def __init__(self, output_size=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x, output_size=None):
        output_size = output_size if output_size is not None else self.output_size
        assert output_size is not None, "AdaptiveAvgPool2d needs output_size"
        return x.adaptive_avg_pool2d(output_size)

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        if "shape" in attributes:
            return AdaptiveAvgPool2d(output_size=attributes["shape"])
        return AdaptiveAvgPool2d()


class AdaptiveMaxPool2d(Module):
    """(reference module.py:2826)"""

    def __init__(self, output_size=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x, output_size=None):
        output_size = output_size if output_size is not None else self.output_size
        assert output_size is not None, "AdaptiveMaxPool2d needs output_size"
        return x.adaptive_max_pool2d(output_size)

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        if "shape" in attributes:
            return AdaptiveMaxPool2d(output_size=attributes["shape"])
        return AdaptiveMaxPool2d()


class _Pool2d(Module):
    """Average or max pooling (reference module.py:2624)."""

    def __init__(self, pool_type, kernel_size, stride=None, padding=0, ceil_mode=False):
        super().__init__()
        self.pool_type = pool_type
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        kwargs = {"stride": self.stride, "padding": self.padding, "ceil_mode": self.ceil_mode}
        if self.pool_type == "average":
            return x.avg_pool2d(self.kernel_size, **kwargs)
        if self.pool_type == "max":
            return x.max_pool2d(self.kernel_size, **kwargs)
        raise ValueError(f"unknown pooling type {self.pool_type}")

    @staticmethod
    def from_onnx(pool_type, attributes=None):
        from .module import AvgPool2d, MaxPool2d

        attributes = attributes or {}
        kernel = _scalar_or_tuple(_as_int_list(attributes.get("kernel_shape", [2])))
        stride = _scalar_or_tuple(_as_int_list(attributes.get("strides", _as_int_list(kernel))))
        padding = _scalar_or_tuple(_onnx_symmetric_pads(attributes.get("pads", [0])))
        ceil_mode = bool(attributes.get("ceil_mode", 0))
        cls = AvgPool2d if pool_type == "average" else MaxPool2d
        return cls(kernel, stride=stride, padding=padding, ceil_mode=ceil_mode)


class BatchNormalization(Module):
    """ONNX inference BatchNorm: input [x, weight, bias, mean, var]
    (reference module.py:3047)."""

    def __init__(self, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.inv_var = None

    def forward(self, x):
        inp, weight, bias, running_mean, running_var = x
        return _registered("batchnorm", inp, weight, bias, running_mean=running_mean,
                           running_var=running_var, training=self.training, eps=self.eps,
                           momentum=self.momentum, inv_var=self.inv_var)

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        return BatchNormalization(eps=attributes.get("epsilon", 1e-5),
                                  momentum=attributes.get("momentum", 0.1))


class LayerNormalization(Module):
    """ONNX LayerNorm over the last dims: input [x, weight, bias]
    (reference module.py:2903)."""

    def __init__(self, eps=1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        from .module import layernorm

        inp, weight, bias = x
        return layernorm(inp, weight, bias, eps=self.eps, dims=len(weight.shape))

    @staticmethod
    def from_onnx(attributes=None):
        attributes = attributes or {}
        return LayerNormalization(eps=attributes.get("epsilon", 1e-5))


class SILU(Module):
    """The ONNX-name alias of SiLU (reference module.py:2527)."""

    def forward(self, x):
        return x.silu()

    @staticmethod
    def from_onnx(attributes=None):
        return SILU()
