"""PlainTensor: a converted graph run unencrypted through the same modules
(counterpart of ``curl_tpu/nn/plain.py``).

The reference's modules run on plain torch tensors until ``encrypt()``
swaps their parameters for CrypTensors. The port's modules are written
against the MPCTensor method surface, so plaintext execution needs an
adapter: PlainTensor holds a float64 tensor on the session's device and
exposes the MPCTensor methods that modules call (matmul, t, sigmoid, ...),
each computed exactly in float64. ``Graph`` and ``GraphModule`` wrap
unencrypted inputs themselves, so ``graph(x)`` with a numpy array or a torch
tensor runs the graph in the clear.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import comm

__all__ = ["PlainTensor", "wrap_plain", "unwrap_plain"]

F = torch.nn.functional


def _pair(v, n=2):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _dims(dim):
    return tuple(dim) if isinstance(dim, (tuple, list)) else dim


class PlainTensor:
    __slots__ = ("v",)

    def __init__(self, v):
        v = getattr(v, "v", v)
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, dtype=np.float64))
        self.v = v.to(device=comm.get_device(), dtype=torch.float64)

    # -- interop --------------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.get_plain_text(), dtype)

    def get_plain_text(self):
        return self.v.detach().cpu().numpy()

    def __repr__(self):
        return f"PlainTensor(shape={tuple(self.v.shape)})"

    # -- structure -------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.v.shape)

    @property
    def ndim(self):
        return self.v.dim()

    def size(self, dim=None):
        return self.shape if dim is None else self.shape[dim]

    def dim(self):
        return self.v.dim()

    def _w(self, x):
        return PlainTensor(x)

    @staticmethod
    def _val(x):
        if isinstance(x, PlainTensor):
            return x.v
        if isinstance(x, torch.Tensor):
            return x.to(device=comm.get_device(), dtype=torch.float64)
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=comm.get_device())

    # -- shape ops ---------------------------------------------------------
    def t(self):
        return self if self.v.dim() < 2 else self._w(self.v.transpose(-1, -2))

    def transpose(self, a, b):
        return self._w(self.v.transpose(a, b))

    def permute(self, *dims):
        if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
            dims = tuple(dims[0])
        return self._w(self.v.permute(*dims))

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._w(self.v.reshape(shape))

    view = reshape

    def flatten(self, start_dim=0, end_dim=-1):
        return self._w(self.v.flatten(start_dim, end_dim))

    def unsqueeze(self, dim):
        return self._w(self.v.unsqueeze(dim))

    def squeeze(self, dim=None):
        return self._w(self.v.squeeze() if dim is None else self.v.squeeze(dim))

    def narrow(self, dim, start, length):
        return self._w(self.v.narrow(dim, start, length))

    def split(self, size, dim=0):
        return [self._w(p) for p in torch.split(self.v, size, dim=dim)]

    def roll(self, shifts, dims=None):
        return self._w(torch.roll(self.v, shifts, dims))

    def expand(self, *sizes):
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        return self._w(self.v.expand(*sizes))

    def take(self, index, dimension=None):
        index = torch.as_tensor(np.asarray(index), dtype=torch.int64, device=self.v.device)
        if dimension is None:
            return self._w(self.v.reshape(-1)[index])
        return self._w(torch.index_select(self.v, dimension, index.reshape(-1)).reshape(
            self.shape[:dimension] + tuple(index.shape) + self.shape[dimension + 1:]))

    def pad(self, pad, value=0.0, mode="constant"):
        return self._w(F.pad(self.v, tuple(int(p) for p in pad), value=float(value)))

    def __getitem__(self, idx):
        return self._w(self.v[idx])

    # -- arithmetic --------------------------------------------------------
    def add(self, y):
        return self._w(self.v + self._val(y))

    def sub(self, y):
        return self._w(self.v - self._val(y))

    def mul(self, y):
        return self._w(self.v * self._val(y))

    def div(self, y):
        return self._w(self.v / self._val(y))

    def neg(self):
        return self._w(-self.v)

    def matmul(self, y):
        return self._w(self.v @ self._val(y))

    def square(self):
        return self._w(self.v * self.v)

    def pow(self, p):
        return self._w(self.v ** p)

    def sum(self, axis=None, keepdim=False):
        if axis is None:
            return self._w(self.v.sum())
        return self._w(self.v.sum(dim=_dims(axis), keepdim=keepdim))

    def mean(self, axis=None, keepdim=False):
        if axis is None:
            return self._w(self.v.mean())
        return self._w(self.v.mean(dim=_dims(axis), keepdim=keepdim))

    def var(self, axis=None, keepdim=False, unbiased=False):
        return self._w(torch.var(self.v, dim=_dims(axis), keepdim=keepdim,
                                 correction=1 if unbiased else 0))

    __add__ = __radd__ = add
    __sub__ = sub
    __mul__ = __rmul__ = mul
    __truediv__ = div
    __matmul__ = matmul
    __neg__ = neg

    def __rsub__(self, y):
        return self._w(self._val(y) - self.v)

    # -- nonlinearities (exact float64) ---------------------------------------
    def sigmoid(self):
        return self._w(torch.sigmoid(self.v))

    def relu(self):
        return self._w(torch.relu(self.v))

    def gelu(self):
        return self._w(F.gelu(self.v))

    def silu(self):
        return self._w(F.silu(self.v))

    def tanh(self):
        return self._w(torch.tanh(self.v))

    def exp(self):
        return self._w(torch.exp(self.v))

    def log(self):
        return self._w(torch.log(self.v))

    def sqrt(self):
        return self._w(torch.sqrt(self.v))

    def reciprocal(self):
        return self._w(1.0 / self.v)

    def inv_sqrt(self):
        return self._w(torch.rsqrt(self.v))

    def max_value(self, dim=None, keepdim=False):
        if dim is None:
            return self._w(self.v.max())
        return self._w(self.v.amax(dim=dim, keepdim=keepdim))

    def evaluate_embed(self, embed):
        """Plain embedding lookup: the table's rows at the integer indices,
        what the private one-hot protocol computes."""
        return self._w(self._val(embed)[self.v.to(torch.int64)])

    def softmax(self, dim=-1, mask=None, **kw):
        # the public mask as the encrypted softmax takes it: masked lanes 0
        x = self.v
        if mask is not None:
            x = x.masked_fill(self._val(mask) == 0, float("-inf"))
        return self._w(torch.softmax(x, dim))

    def log_softmax(self, dim=-1, mask=None, **kw):
        x = self.v
        if mask is not None:
            x = x.masked_fill(self._val(mask) == 0, float("-inf"))
        return self._w(torch.log_softmax(x, dim))

    def dropout(self, p=0.5, training=False, inplace=False):
        return self

    def hardtanh(self, min_value=-1.0, max_value=1.0):
        return self._w(self.v.clamp(min_value, max_value))

    def erf(self):
        return self._w(torch.erf(self.v))

    # -- comparisons ---------------------------------------------------------
    def ge(self, y):
        return self._w((self.v >= self._val(y)).to(torch.float64))

    def gt(self, y):
        return self._w((self.v > self._val(y)).to(torch.float64))

    def le(self, y):
        return self._w((self.v <= self._val(y)).to(torch.float64))

    def lt(self, y):
        return self._w((self.v < self._val(y)).to(torch.float64))

    def eq(self, y):
        return self._w((self.v == self._val(y)).to(torch.float64))

    def abs(self):
        return self._w(self.v.abs())

    def max(self, dim=None, keepdim=False, one_hot=False):
        if dim is None:
            return self._w(self.v.max())
        m, a = self.v.max(dim=dim, keepdim=keepdim)
        return self._w(m), self._w(a.to(torch.float64))

    def min(self, dim=None, keepdim=False, one_hot=False):
        if dim is None:
            return self._w(self.v.min())
        m, a = self.v.min(dim=dim, keepdim=keepdim)
        return self._w(m), self._w(a.to(torch.float64))

    # -- conv / pooling ------------------------------------------------------
    def conv2d(self, kernel, stride=1, padding=0, dilation=1, groups=1):
        return self._w(F.conv2d(self.v, self._val(kernel), stride=_pair(stride),
                                padding=_pair(padding), dilation=_pair(dilation), groups=groups))

    def conv1d(self, kernel, stride=1, padding=0, dilation=1, groups=1):
        return self._w(F.conv1d(self.v, self._val(kernel), stride=_pair(stride, 1),
                                padding=_pair(padding, 1), dilation=_pair(dilation, 1),
                                groups=groups))

    def max_pool2d(self, kernel_size, stride=None, padding=0, **kw):
        stride = kernel_size if stride is None else stride
        return self._w(F.max_pool2d(self.v, kernel_size, stride=stride, padding=padding))

    def avg_pool2d(self, kernel_size, stride=None, padding=0, **kw):
        # the window's sum over its k x k cells, padding included, as the
        # JAX package's reduce_window divides it
        stride = kernel_size if stride is None else stride
        return self._w(F.avg_pool2d(self.v, kernel_size, stride=stride, padding=padding,
                                    count_include_pad=True))

    def adaptive_avg_pool2d(self, output_size):
        return self._w(F.adaptive_avg_pool2d(self.v, output_size))

    def adaptive_max_pool2d(self, output_size):
        return self._w(F.adaptive_max_pool2d(self.v, output_size))

    def clone(self):
        return self._w(self.v.clone())


def wrap_plain(x):
    """Wrap plain arrays and tensors; pass encrypted tensors (and anything
    else) through."""
    from ..mpc.mpc import MPCTensor

    if isinstance(x, (PlainTensor, MPCTensor)):
        return x
    if isinstance(x, (np.ndarray, torch.Tensor)) or (np.isscalar(x) and not isinstance(x, str)):
        return PlainTensor(x)
    return x


def unwrap_plain(x):
    """A PlainTensor (or a tuple or list of them) back to numpy."""
    if isinstance(x, PlainTensor):
        return x.get_plain_text()
    if isinstance(x, (tuple, list)):
        return type(x)(unwrap_plain(e) for e in x)
    return x
