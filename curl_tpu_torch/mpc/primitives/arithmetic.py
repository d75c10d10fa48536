"""Additive secret sharing over Z_2^64 with an explicit party axis.

Counterpart of ``curl_tpu/mpc/primitives/arithmetic.py``. ``share`` is a
``(P, *shape)`` int64 tensor holding every party's share; ``shape`` is the
per-party shape, as in the JAX package's per-party view. ``reveal`` sums
over the party axis (``comm.all_sum``). Semantics follow the JAX package:
PRZS sharing, public/private dispatch, the post-multiply rescale by EGK
probabilistic truncation or 2PC local truncation. With ``mpc.fused_mul`` /
``mpc.fused_trunc`` = "cuda" (off as shipped) an elementwise product, a
square and an l = 62 EGK truncation of 2 parties run as one fused pass
(``kernels/fused_mul.py``) under the JAX package's gates.
"""

from __future__ import annotations

import math
import numbers
from typing import Optional

import numpy as np
import torch

from ... import comm
from ... import random as rng
from ... import ring
from ...config import cfg
from ...encoder import FixedPointEncoder
from .party import lift, rank0


def _is_public(value) -> bool:
    return isinstance(value, (numbers.Number, np.ndarray, torch.Tensor, list, tuple))


def _get_protocol():
    """The module of ``mpc.protocol``: Beaver triples or replicated
    sharing (arithmetic.py:55-59)."""
    from . import beaver, replicated

    protocols = {"beaver": beaver, "replicated": replicated}
    if cfg.mpc.protocol not in protocols:
        raise ValueError(f"mpc.protocol is 'beaver' or 'replicated', not {cfg.mpc.protocol!r}")
    return protocols[cfg.mpc.protocol]


def _public_tensor(value, constant: bool = False):
    """Public value -> tensor on the session device (floats as float64).
    ``constant``: a host value is a public operand of a forward, copied
    once and cached (``ring.host_constant``), never on each use."""
    if isinstance(value, torch.Tensor):
        return value.to(comm.get_device())
    arr = np.asarray(value)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float64)
    if constant:
        return ring.host_constant(arr, comm.get_device())
    return torch.from_numpy(np.ascontiguousarray(arr)).to(comm.get_device())


def _encode(encoder, y):
    """Encoded public value: Python int for scalars, else an int64 tensor."""
    if isinstance(y, numbers.Number):
        return encoder.encode(y)
    return encoder.encode(_public_tensor(y, constant=True))


class ArithmeticSharedTensor:
    __slots__ = ("share", "encoder")

    def __init__(self, share: torch.Tensor, encoder: FixedPointEncoder):
        self.share = share
        self.encoder = encoder

    # -- constructors ------------------------------------------------------
    @classmethod
    def encrypt(cls, value, src: int = 0, precision: Optional[int] = None):
        """Share a plaintext provided by party ``src``: one Philox share pass."""
        enc = FixedPointEncoder(precision)
        value = _public_tensor(value)
        if not value.dtype.is_floating_point and precision != 0:
            value = value.to(torch.float64)
        encoded = torch.as_tensor(enc.encode(value), dtype=torch.int64, device=comm.get_device())
        return cls(rng.przs_share(encoded, src), enc)

    @classmethod
    def from_shares(cls, share, precision: Optional[int] = None):
        return cls(ring.to_ring(share), FixedPointEncoder(precision))

    @classmethod
    def PRSS(cls, shape):
        """A pseudo-random secret sharing of a random value: each party's
        own ``local`` draw (arithmetic.py:127)."""
        return cls(rng.random_ring(tuple(shape), "local"), FixedPointEncoder())

    # -- structure ---------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.share.shape[1:])

    @property
    def ndim(self):
        return self.share.dim() - 1

    def with_share(self, share) -> "ArithmeticSharedTensor":
        return ArithmeticSharedTensor(share, self.encoder)

    def clone(self):
        """The same shares under the same encoder (arithmetic.py:136): the
        share tensor is shared, as no op writes a share in place."""
        return ArithmeticSharedTensor(self.share, self.encoder)

    def __repr__(self):
        return f"ArithmeticSharedTensor(shape={self.shape}, scale={self.encoder.scale})"

    # -- reveal / decode ---------------------------------------------------
    def reveal(self) -> torch.Tensor:
        """Ring reconstruction: one counted reveal round."""
        return comm.all_sum(self.share)

    def get_plain_text(self) -> np.ndarray:
        """Decode on the host (no protocol round, like the JAX package's
        eager CrypTensor.get_plain_text)."""
        return self.encoder.decode(self.share.sum(dim=0))

    # -- public/private arithmetic dispatch --------------------------------
    def _add_sub(self, y, op: str):
        sign = 1 if op == "add" else -1
        if _is_public(y):
            # party 0 adds the encoded public value (arithmetic.py:364-368)
            encoded = _encode(self.encoder, y)
            if isinstance(encoded, int):
                return self.with_share(self.share + rank0(ring.scalar(sign * encoded), self.shape))
            nd = max(self.ndim, encoded.dim())
            return self.with_share(lift(self.share, nd) + sign * rank0(encoded, ndim=nd))
        a, b = self, y
        if a.encoder.scale > b.encoder.scale:
            b = b.encode_as(a)
        elif a.encoder.scale < b.encoder.scale:
            a = a.encode_as(b)
        nd = max(a.ndim, b.ndim)
        share = lift(a.share, nd) + sign * lift(b.share, nd)
        return ArithmeticSharedTensor(share, a.encoder)

    def add(self, y):
        return self._add_sub(y, "add")

    def sub(self, y):
        return self._add_sub(y, "sub")

    def neg(self):
        return self.with_share(-self.share)

    def _rescale_product(self, result: "ArithmeticSharedTensor", y_scale: int):
        """Post-multiplication rescale (arithmetic.py:389-408)."""
        if self.encoder.scale > 1 and y_scale > 1:
            if cfg.encoder.trunc_method.prod == "crypten":
                return result.div_trunc(result.encoder.scale)
            return result.egk_trunc_pr(62, result.encoder.precision_bits)
        if self.encoder.scale > 1:
            return ArithmeticSharedTensor(result.share, self.encoder)
        return ArithmeticSharedTensor(
            result.share, FixedPointEncoder(int(math.log2(max(y_scale, 1))))
        )

    def _fused_mul_mode(self, y):
        """(trunc, m) for the fused elementwise product, or None for the
        composable path: both operands fixed-point or both integers; a
        mixed-scale product keeps the composable rescale bookkeeping."""
        from ...kernels import fused_mul

        if not fused_mul.fused_available(self, y):
            return None
        if self.encoder.scale > 1 and y.encoder.scale > 1:
            return str(cfg.encoder.trunc_method.prod), self.encoder.precision_bits
        if self.encoder.scale == 1 and y.encoder.scale == 1:
            return "none", 0
        return None

    def mul(self, y):
        if isinstance(y, numbers.Integral) and not isinstance(y, bool):
            return self.with_share(self.share * ring.scalar(int(y)))
        if _is_public(y):
            encoded = _encode(self.encoder, y)
            if isinstance(encoded, int):
                out = self.with_share(self.share * encoded)
            else:
                nd = max(self.ndim, encoded.dim())
                out = self.with_share(lift(self.share, nd) * encoded)
            return self._rescale_product(out, self.encoder.scale)
        fused = self._fused_mul_mode(y)
        if fused is not None:
            from ...kernels import fused_mul

            return fused_mul.fused_mul_mpc(self, y, *fused)
        out = _get_protocol().mul(self, y)
        return self._rescale_product(out, y.encoder.scale)

    def matmul(self, y):
        if _is_public(y):
            encoded = _encode(self.encoder, y)
            nd = max(self.ndim, encoded.dim())
            out = self.with_share(ring.matmul(lift(self.share, nd), encoded))
            return self._rescale_product(out, self.encoder.scale)
        out = _get_protocol().matmul(self, y)
        return self._rescale_product(out, y.encoder.scale)

    def conv1d(self, kernel, **kwargs):
        return self._conv(kernel, "conv1d", **kwargs)

    def conv2d(self, kernel, **kwargs):
        return self._conv(kernel, "conv2d", **kwargs)

    def conv_transpose1d(self, kernel, **kwargs):
        return self._conv(kernel, "conv_transpose1d", **kwargs)

    def conv_transpose2d(self, kernel, **kwargs):
        return self._conv(kernel, "conv_transpose2d", **kwargs)

    def _conv(self, kernel, op, **kwargs):
        """A convolution by a public kernel (the ring's, on every party's
        share at once) or a private one (a Beaver protocol), then the
        product's rescale (arithmetic.py:276-283)."""
        if _is_public(kernel):
            encoded = _encode(self.encoder, kernel)
            out = self.with_share(getattr(ring, op)(self.share, encoded, **kwargs))
            return self._rescale_product(out, self.encoder.scale)
        out = getattr(_get_protocol(), op)(self, kernel, **kwargs)
        return self._rescale_product(out, kernel.encoder.scale)

    def square(self):
        from ...kernels import fused_mul

        if fused_mul.fused_available(self):
            # always the local crypten rescale, as the composable path below
            return fused_mul.fused_square_mpc(self, "crypten", fused_mul.square_bits(self))
        out = _get_protocol().square(self)
        return out.div_trunc(self.encoder.scale)

    # -- division / truncation --------------------------------------------
    def div_trunc(self, divisor: int):
        """Divide by a public positive integer (arithmetic.py:452-481): 2PC
        local signed truncation of each share; more parties correct the
        wraps with the ``truncate`` protocol."""
        if comm.get_world_size() > 2:
            return _get_protocol().truncate(self, int(divisor))
        return self.with_share(ring.trunc_div_signed(self.share, int(divisor)))

    def div(self, y):
        if isinstance(y, numbers.Real) and not isinstance(y, numbers.Integral):
            if float(y).is_integer():
                y = int(y)
        if isinstance(y, numbers.Integral):
            return self.div_trunc(int(y))
        if isinstance(y, numbers.Real):
            return self.mul(1.0 / y)
        return self.mul(1.0 / _public_tensor(y, constant=True).to(torch.float64))

    def divmod(self, y: int):
        """(self // y, self % y) in the encoded domain (arithmetic.py:327):
        the local truncation, then the remainder self - y * (self // y)."""
        divisor = self.div(y)
        return divisor, self.sub(divisor.mul(int(y)))

    def mod(self, y: int):
        return self.divmod(y)[1]

    def egk_trunc_pr(self, l: int, m: int):
        """EGK+20 probabilistic truncation by m bits (arithmetic.py:508)."""
        if m == 0:
            return self
        from ...kernels import fused_mul

        # the fused pass implements l = 62, the only l of the product
        # rescale and the LUT index truncations
        if l == fused_mul.EGK_L and fused_mul.fused_available(self, key="fused_trunc"):
            return fused_mul.fused_trunc_mpc(self, m)
        return ArithmeticSharedTensor(
            _get_protocol().egk_trunc_pr(self, l, m).share, self.encoder
        )

    def egk_truncmod_pr(self, l: int, m: int):
        """(truncation, remainder) pair (arithmetic.py:515-519)."""
        divisor = self.egk_trunc_pr(l, m)
        remainder = self.share - divisor.share * ring.scalar(1 << m)
        return divisor, ArithmeticSharedTensor(remainder, self.encoder)

    # -- LUT protocol entry points ----------------------------------------
    def evaluate_lut(self, lut):
        return ArithmeticSharedTensor(
            _get_protocol().evaluate_lut(self, lut).share, self.encoder
        )

    def evaluate_bior_lut(self, luts, scale: "ArithmeticSharedTensor", bias: int):
        return ArithmeticSharedTensor(
            _get_protocol().evaluate_bior_lut(self, luts, scale, bias).share, self.encoder
        )

    def evaluate_embed(self, embed: "ArithmeticSharedTensor"):
        out = _get_protocol().evaluate_embed(self, embed)
        return ArithmeticSharedTensor(out.share, embed.encoder)

    # -- scale management --------------------------------------------------
    def encode_to(self, new_encoder: FixedPointEncoder):
        if self.encoder.scale == new_encoder.scale:
            return ArithmeticSharedTensor(self.share, new_encoder)
        if self.encoder.scale < new_encoder.scale:
            factor = new_encoder.scale // self.encoder.scale
            return ArithmeticSharedTensor(self.share * ring.scalar(factor), new_encoder)
        factor = self.encoder.scale // new_encoder.scale
        return ArithmeticSharedTensor(self.div_trunc(factor).share, new_encoder)

    def encode_as(self, other: "ArithmeticSharedTensor"):
        return self.encode_to(other.encoder)

    def pad(self, pad_width, value=0):
        """Constant-pad the trailing dims (torch's F.pad convention):
        party 0 holds the encoded public ``value`` in the pad, the others 0."""
        padded = torch.nn.functional.pad(self.share, tuple(pad_width), value=0)
        encoded = _encode(self.encoder, value)
        region = torch.nn.functional.pad(
            torch.zeros(self.shape, dtype=torch.int64, device=self.share.device),
            tuple(pad_width), value=encoded,
        )
        return self.with_share(padded + rank0(region, ndim=self.ndim))

    # -- indexed writes (arithmetic.py:448-486): local, no communication ---
    def _indexed_values(self, values):
        """A private operand's shares, or a public one encoded and held
        by party 0 (the others add 0)."""
        if _is_public(values):
            encoded = _encode(self.encoder, values)
            if isinstance(encoded, int):
                encoded = torch.full((), encoded, dtype=torch.int64, device=self.share.device)
            return rank0(encoded, ndim=encoded.dim())
        return values.share

    def index_add(self, dim, index, tensor):
        """Add ``tensor``'s entries at ``index`` along ``dim``."""
        dim = dim % self.ndim
        index = ring.constant(index, self.share.device).reshape(-1)
        shape = list(self.share.shape)
        shape[dim + 1] = index.numel()
        values = self._indexed_values(tensor)
        values = lift(values, len(shape) - 1).expand(shape)
        return self.with_share(self.share.index_add(dim + 1, index, values))

    def _scatter_args(self, dim, index, values):
        index = ring.constant(index, self.share.device)
        shape = (self.share.shape[0],) + tuple(index.shape)
        values = lift(self._indexed_values(values), index.dim()).expand(shape)
        return dim % self.ndim + 1, index.unsqueeze(0).expand(shape), values

    def scatter_add(self, dim, index, other):
        """Add ``other`` at the positions ``index`` names along ``dim``
        (torch's scatter_add: every other dim by position)."""
        d, index, values = self._scatter_args(dim, index, other)
        return self.with_share(self.share.scatter_add(d, index, values))

    def scatter(self, dim, index, src):
        """Replace the entries ``index`` names along ``dim`` with ``src``."""
        d, index, values = self._scatter_args(dim, index, src)
        return self.with_share(self.share.scatter(d, index, values))

    @staticmethod
    def stack(tensors, axis=0):
        axis = axis + 1 if axis >= 0 else axis
        return ArithmeticSharedTensor(
            torch.stack([t.share for t in tensors], dim=axis), tensors[0].encoder
        )

    @staticmethod
    def cat(tensors, axis=0):
        axis = axis + 1 if axis >= 0 else axis
        return ArithmeticSharedTensor(
            torch.cat([t.share for t in tensors], dim=axis), tensors[0].encoder
        )

    def avg_pool2d(self, kernel_size, stride=None, padding=0, ceil_mode=False):
        """The window sum divided by the whole window, padding included
        (arithmetic.py:488-496)."""
        if ceil_mode:
            raise NotImplementedError("ceil_mode not supported for avg_pool2d")
        z = self._sum_pool2d(kernel_size, stride=stride, padding=padding)
        k = (kernel_size, kernel_size) if isinstance(kernel_size, (int, float)) else kernel_size
        return z.div(int(k[0]) * int(k[1]))

    def _sum_pool2d(self, kernel_size, stride=None, padding=0):
        """Each window's sum of shares over the last two dims, zero shares in
        the padding (arithmetic.py:498-515): local, no communication."""
        k = (int(kernel_size),) * 2 if isinstance(kernel_size, (int, float)) else tuple(kernel_size)
        s = k if stride is None else ((stride,) * 2 if isinstance(stride, int) else tuple(stride))
        p = (padding,) * 2 if isinstance(padding, int) else tuple(padding)
        share = torch.nn.functional.pad(self.share, (p[1], p[1], p[0], p[0]))
        d = share.dim()
        windows = share.unfold(d - 2, k[0], s[0]).unfold(d - 1, k[1], s[1])
        return self.with_share(windows.sum(dim=(-2, -1)))
