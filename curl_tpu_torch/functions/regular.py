"""Communication-free share-structure ops, party axis explicit.

Counterpart of ``curl_tpu/functions/regular.py``. Every op takes per-party
dims, as the JAX package's per-party view does, and moves the share's dims
one place right to skip the leading party axis. Installed on
ArithmeticSharedTensor, BinarySharedTensor and MPCTensor alike; the
protocol-using reductions (mean, var, prod) on the arithmetic types.
"""

from __future__ import annotations

import math

import torch

from .. import ring
from ..mpc.mpc import MPCTensor
from ..mpc.primitives.arithmetic import ArithmeticSharedTensor
from ..mpc.primitives.binary import BinarySharedTensor


def _ax(dim: int) -> int:
    """Per-party dim -> share dim."""
    return dim + 1 if dim >= 0 else dim


def _sizes(args):
    return tuple(args[0]) if len(args) == 1 and isinstance(args[0], (tuple, list)) else args


def _structure_ops():
    def view(self, *shape):
        return self.with_share(self.share.reshape((self.share.shape[0],) + _sizes(shape)))

    def flatten(self, start_dim=0, end_dim=-1):
        return self.with_share(self.share.flatten(_ax(start_dim), _ax(end_dim)))

    def squeeze(self, axis=None):
        if axis is None:
            return view(self, *[s for s in self.shape if s != 1])
        return self.with_share(self.share.squeeze(_ax(axis)))

    def unsqueeze(self, axis):
        if axis < 0:
            axis += self.share.dim()
        return self.with_share(self.share.unsqueeze(axis + 1))

    def transpose(self, dim0, dim1):
        return self.with_share(self.share.transpose(_ax(dim0), _ax(dim1)))

    def t(self):
        # ndim, not share.dim(): reading a compressed tensor's share expands it
        return self if self.ndim < 2 else self.with_share(self.share.transpose(-1, -2))

    def permute(self, *dims):
        nd = self.share.dim() - 1
        return self.with_share(self.share.permute(0, *[d % nd + 1 for d in _sizes(dims)]))

    def roll(self, shifts, dims):
        return self.with_share(torch.roll(self.share, shifts, dims=_ax(dims)))

    def expand(self, *sizes):
        sizes = _sizes(sizes)
        cur = self.shape
        offset = len(sizes) - len(cur)
        target = [cur[i - offset] if s == -1 else s for i, s in enumerate(sizes)]
        share = self.share.reshape((self.share.shape[0],) + (1,) * offset + cur)
        return self.with_share(share.expand((self.share.shape[0],) + tuple(target)))

    def narrow(self, dim, start, length):
        return self.with_share(self.share.narrow(_ax(dim), start, length))

    def index_select(self, dim, index):
        index = ring.constant(index, self.share.device)
        return self.with_share(torch.index_select(self.share, _ax(dim), index.reshape(-1)))

    def getitem(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        return self.with_share(self.share[(slice(None),) + idx])

    def cumsum(self, dim):
        return self.with_share(torch.cumsum(self.share, dim=_ax(dim)))

    def sum_(self, axis=None, keepdim=False):
        if axis is None:
            axis = tuple(range(self.share.dim() - 1))
        axes = tuple(_ax(a) for a in (axis if isinstance(axis, (tuple, list)) else (axis,)))
        return self.with_share(self.share.sum(dim=axes, keepdim=keepdim))

    def flip(self, dims):
        dims = dims if isinstance(dims, (tuple, list)) else (dims,)
        return self.with_share(self.share.flip(tuple(_ax(d) for d in dims)))

    def gather(self, dim, index):
        """Entries along ``dim`` at ``index`` (numpy's take_along_axis:
        the other dims of index and tensor broadcast)."""
        index = ring.constant(index, self.share.device)
        dim = dim % self.ndim
        shape = list(torch.broadcast_shapes(
            tuple(1 if d == dim else n for d, n in enumerate(self.shape)),
            tuple(1 if d == dim else n for d, n in enumerate(index.shape))))
        share = self.share.expand((self.share.shape[0],) + tuple(
            self.shape[d] if d == dim else n for d, n in enumerate(shape)))
        shape[dim] = index.shape[dim]
        index = index.expand(shape).unsqueeze(0).expand((share.shape[0],) + tuple(shape))
        return self.with_share(torch.gather(share, dim + 1, index))

    def take(self, index, dimension=None):
        if dimension is None:
            index = ring.constant(index, self.share.device)
            return self.with_share(self.share.reshape(self.share.shape[0], -1)[:, index])
        return index_select(self, dimension, index)

    def repeat(self, *reps):
        """numpy's tile of each party's share (regular.py:125-128)."""
        reps = _sizes(reps)
        nd = max(len(reps), self.ndim)
        reps = (1,) * (nd - len(reps)) + tuple(reps)
        share = self.share.reshape((self.share.shape[0],) + (1,) * (nd - self.ndim) + self.shape)
        return self.with_share(share.repeat((1,) + reps))

    def unfold(self, dimension, size, step):
        """The windows of ``size`` at ``step`` along ``dimension``, which
        becomes their count; a trailing axis of ``size`` (Tensor.unfold)."""
        return self.with_share(self.share.unfold(_ax(dimension % self.ndim), size, step))

    def trace_(self):
        return self.with_share(self.share.diagonal(dim1=1, dim2=2).sum(-1))

    def chunk(self, chunks, dim=0):
        return split(self, -(-self.shape[dim] // chunks), dim=dim)

    def unbind(self, dim=0):
        return [self.with_share(self.share.select(_ax(dim), i)) for i in range(self.shape[dim])]

    def split(self, split_size, dim=0):
        n = self.shape[dim]
        if isinstance(split_size, int):
            sizes = [split_size] * (n // split_size) + ([n % split_size] if n % split_size else [])
        else:
            sizes = list(split_size)
        outs, start = [], 0
        for s in sizes:
            outs.append(narrow(self, dim, start, s))
            start += s
        return outs

    return {
        "view": view,
        "reshape": view,
        "flatten": flatten,
        "squeeze": squeeze,
        "unsqueeze": unsqueeze,
        "transpose": transpose,
        "t": t,
        "permute": permute,
        "roll": roll,
        "expand": expand,
        "narrow": narrow,
        "index_select": index_select,
        "__getitem__": getitem,
        "cumsum": cumsum,
        "sum": sum_,
        "split": split,
        "flip": flip,
        "gather": gather,
        "take": take,
        "repeat": repeat,
        "unfold": unfold,
        "trace": trace_,
        "chunk": chunk,
        "unbind": unbind,
    }


_OPS = _structure_ops()

for _cls in (ArithmeticSharedTensor, BinarySharedTensor):
    for _name, _fn in _OPS.items():
        if _name not in _cls.__dict__:
            setattr(_cls, _name, _fn)


def _mpc_forward(name):
    def fwd(self, *args, **kwargs):
        out = getattr(self._tensor, name)(*args, **kwargs)
        if isinstance(out, list):
            return [MPCTensor(o, self.ptype) for o in out]
        return MPCTensor(out, self.ptype)

    fwd.__name__ = name
    return fwd


for _name in _OPS:
    if _name not in MPCTensor.__dict__:
        setattr(MPCTensor, _name, _mpc_forward(_name))


# -- protocol-using reductions -----------------------------------------------

def _count(shape, axis):
    if axis is None:
        return math.prod(shape)
    if isinstance(axis, (tuple, list)):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def mean(self, axis=None, keepdim=False):
    """sum / n (reference regular.py:151)."""
    return self.sum(axis=axis, keepdim=keepdim).div(_count(self.shape, axis))


def var(self, axis=None, keepdim=False, unbiased=False):
    """E[(x - mean)^2] (reference regular.py:164)."""
    m = mean(self, axis=axis, keepdim=True) if axis is not None else mean(self)
    total = (self - m).square().sum(axis=axis, keepdim=keepdim)
    n = _count(self.shape, axis)
    return total.div(n - 1 if unbiased else n)


def prod(self, axis=None, keepdim=False):
    """Tree product along an axis, log-depth private muls."""
    if axis is None:
        flat = self.flatten()
        return prod(flat, axis=0) if flat.shape[0] > 1 else flat[0]
    x = self
    n = x.shape[axis]
    while n > 1:
        half = n // 2
        m = x.narrow(axis, 0, half).mul(x.narrow(axis, half, half))
        if n % 2 == 1:
            x = type(m).cat([m, x.narrow(axis, 2 * half, 1)], axis=axis)
        else:
            x = m
        n = half + (n % 2)
    return x if keepdim else x.squeeze(axis)


def dot(self, y, weights=None):
    """The dot product of the flattened tensors (regular.py:287-292)."""
    y = y.flatten() if isinstance(y, (MPCTensor, ArithmeticSharedTensor)) else _flat_public(y)
    result = self.flatten().mul(y)
    if weights is not None:
        result = result.mul(weights)
    return result.sum()


def ger(self, y):
    """The outer product (regular.py:295-299): one private matmul."""
    b = y.view(1, -1) if isinstance(y, (MPCTensor, ArithmeticSharedTensor)) else (
        _flat_public(y).reshape(1, -1))
    return self.view(-1, 1).matmul(b)


def _flat_public(y):
    if isinstance(y, torch.Tensor):
        return y.reshape(-1)
    import numpy as np

    return np.ravel(np.asarray(y))


for _name, _fn in (("mean", mean), ("var", var), ("prod", prod), ("dot", dot), ("ger", ger)):
    setattr(MPCTensor, _name, _fn)
