"""XOR secret sharing over 64-bit words with an explicit party axis.

Counterpart of ``curl_tpu/mpc/primitives/binary.py``: ``share`` is a
``(P, *shape)`` int64 tensor; XOR and shifts are local, AND runs the
binary Beaver protocol, additions run the SPK circuits (``circuit.py``), and
reveal is an XOR over the party axis (``comm.all_xor``).
"""

from __future__ import annotations

import numbers
from typing import Optional

import torch

from ... import comm
from ... import random as rng
from ... import ring
from ...encoder import FixedPointEncoder
from .party import lift


class BinarySharedTensor:
    __slots__ = ("share", "encoder")

    def __init__(self, share: torch.Tensor, encoder: Optional[FixedPointEncoder] = None):
        self.share = share
        self.encoder = encoder if encoder is not None else FixedPointEncoder(0)

    # -- constructors ------------------------------------------------------
    @classmethod
    def encrypt(cls, value, src: int = 0, per_party: bool = False):
        """XOR-share a bit-vector held by party ``src``: PRZS ^ its value.
        ``per_party``: ``value`` is (P, ...) and only row ``src`` enters
        (each party sharing its own local value, as in A2B)."""
        value = ring.to_ring(value, comm.get_device())
        return cls(rng.xor_share(value, src, per_party))

    @classmethod
    def from_shares(cls, share):
        return cls(ring.to_ring(share))

    @classmethod
    def rand(cls, shape, bits: int = 64):
        """Uniform random secret bits: each party's local bits, XORed."""
        return cls(rng.random_kbit(shape, bits, "local"))

    # -- structure ---------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.share.shape[1:])

    @property
    def ndim(self):
        return self.share.dim() - 1

    def with_share(self, share) -> "BinarySharedTensor":
        return BinarySharedTensor(share, self.encoder)

    def __repr__(self):
        return f"BinarySharedTensor(shape={self.shape})"

    @staticmethod
    def stack(tensors, axis=0):
        axis = axis + 1 if axis >= 0 else axis
        return BinarySharedTensor(
            torch.stack([t.share for t in tensors], dim=axis), tensors[0].encoder
        )

    # -- reveal ------------------------------------------------------------
    def reveal(self) -> torch.Tensor:
        return comm.all_xor(self.share)

    def get_plain_text(self):
        out = self.share[0].clone()
        for p in range(1, self.share.shape[0]):
            out ^= self.share[p]
        return ring.to_numpy_u64(out)

    # -- bitwise ops -------------------------------------------------------
    def _public(self, y):
        return ring.scalar(int(y)) if isinstance(y, numbers.Integral) else ring.constant(
            y, comm.get_device()
        )

    def __xor__(self, y):
        if isinstance(y, BinarySharedTensor):
            nd = max(self.ndim, y.ndim)
            return self.with_share(lift(self.share, nd) ^ lift(y.share, nd))
        yv = self._public(y)
        if isinstance(yv, int):
            share = self.share.clone()
            share[0] ^= yv
            return self.with_share(share)
        nd = max(self.ndim, yv.dim())
        return self.with_share(lift(self.share, nd) ^ (yv * comm.rank_mask(0, nd)))

    def __and__(self, y):
        if isinstance(y, BinarySharedTensor):
            from . import beaver

            return beaver.AND(self, y)
        yv = self._public(y)
        if isinstance(yv, int):
            return self.with_share(self.share & yv)
        return self.with_share(lift(self.share, max(self.ndim, yv.dim())) & yv)

    def __invert__(self):
        return self ^ -1

    def __lshift__(self, bits):
        return self.with_share(self.share << bits)

    def logical_rshift(self, bits):
        return self.with_share(ring.shift_right_logical(self.share, bits))

    # -- arithmetic-over-binary --------------------------------------------
    def sum(self, axis=0, width=64):
        """Log-tree add over a per-party axis via the SPK adder; ``width <
        64`` adds packed narrow-ring segments independently."""
        from . import circuit

        dim = axis + 1 if axis >= 0 else axis
        n = self.share.shape[dim]
        x = self
        while n > 1:
            half = n // 2
            a = x.with_share(x.share.narrow(dim, 0, half))
            b = x.with_share(x.share.narrow(dim, half, half))
            added = circuit.add(a, b, width=width)
            if n % 2 == 1:
                rem = x.share.narrow(dim, 2 * half, n - 2 * half)
                x = x.with_share(torch.cat([added.share, rem], dim=dim))
                n = half + 1
            else:
                x = added
                n = half
        return x.with_share(x.share.select(dim, 0))
