"""Seed-compressed 2-party arithmetic shares: half the resident share memory.

Counterpart of ``curl_tpu/mpc/primitives/compressed.py``. A fresh additive
sharing of an encoding w is (w - r, r) with r uniform. Since r is generator
output, party 1's share need not be kept: the tensor holds
``share0 = w - stream(key)`` and the 64-bit key, and regenerates the
``(2, *shape)`` share at every use, in one launch of the seed-expansion
kernel (``kernels/seed_expand.py``) that writes only that share. The
expanded share is a transient of the op that reads it; at rest a GPT-Neo
(1.3B parameters) keeps 10.5 GB of share0 where materialized shares take 21.

``t()`` and ``transpose(-1, -2)`` return a compressed view that has not
expanded: the same share0 and key with a transposed flag; its ``share``
expands and then transposes, the stream always indexed by share0's own
layout. A Beaver matmul with such an operand y (2 parties, TFP) never
expands it: ``open`` computes the revealed delta = y - b in one pass of
the seed-expansion kernel, party 1's share drawn in registers.

``share0`` is one int64 tensor. The JAX package keeps it as u32 lo/hi
planes only because the TPU's X64 emulation would split uint64 program
inputs into a second copy of the weights (its compressed.py:90-96); the
card has native 64-bit integers. The JAX package pins the generator of each
tensor at construction; the port has one generator (Philox), so there is
nothing to pin. Inference only: every op reads ``share`` and none writes
into it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import comm
from ...encoder import FixedPointEncoder
from ...kernels import seed_expand
from .arithmetic import ArithmeticSharedTensor, _public_tensor


class SeedCompressedArithmetic(ArithmeticSharedTensor):
    """2-party ArithmeticSharedTensor whose party-1 share is stream(key).

    Every inherited op reads ``self.share`` (the expansion) and returns a
    plain ArithmeticSharedTensor through ``with_share``; ``t``,
    ``transpose`` of the last two dims and ``with_encoder`` return a
    compressed view, and ``open`` is the Beaver open of a matmul operand."""

    # ``share`` is a property here: the parent's slot of that name stays unset
    __slots__ = ("share0", "key", "transposed")

    def __init__(self, share0: torch.Tensor, key: int, encoder: FixedPointEncoder,
                 transposed: bool = False):
        self.share0 = share0
        self.key = key
        self.encoder = encoder
        self.transposed = transposed

    @classmethod
    def encrypt(cls, value, key: int, precision: Optional[int] = None):
        """Compress plaintext ``value`` (party 0's data) under ``key``: one
        pass computes share0 = encode(value) - stream(key); r is not kept."""
        enc = FixedPointEncoder(precision)
        value = _public_tensor(value)
        if not value.dtype.is_floating_point and precision != 0:
            value = value.to(torch.float64)
        encoded = torch.as_tensor(enc.encode(value), dtype=torch.int64,
                                  device=comm.get_device()).contiguous()
        return cls(seed_expand.compress(encoded, key), key, enc)

    @property
    def share(self) -> torch.Tensor:
        """The (P, *shape) share of both parties, expanded in one pass."""
        ws = comm.get_world_size()
        if ws > 2:
            # share0 + r telescopes over exactly two parties; a third would
            # hold another r and decode garbage
            raise RuntimeError(
                f"seed-compressed shares are 2PC-only (world_size={ws}): party 1's "
                "share is the key's stream and further parties would duplicate it. "
                "Use materialized shares (encrypt with seed_compress=False) for ws > 2."
            )
        share = seed_expand.expand(self.share0, self.key, parties=ws)
        return share.transpose(-1, -2) if self.transposed else share

    @property
    def shape(self):
        return seed_expand.view_shape(self.share0, self.transposed)

    @property
    def ndim(self):
        return self.share0.dim()

    def resident_bytes(self) -> int:
        """Bytes kept between uses: share0 and the key."""
        return self.share0.numel() * self.share0.element_size() + 8

    def with_share(self, share) -> ArithmeticSharedTensor:
        return ArithmeticSharedTensor(share, self.encoder)

    def with_encoder(self, encoder: FixedPointEncoder) -> "SeedCompressedArithmetic":
        """The same compressed view under another encoder (no expansion)."""
        return SeedCompressedArithmetic(self.share0, self.key, encoder, self.transposed)

    def t(self):
        """The view transposed in its last two dims, still compressed."""
        if self.ndim < 2:
            return self
        return SeedCompressedArithmetic(self.share0, self.key, self.encoder, not self.transposed)

    def transpose(self, dim0, dim1):
        nd = self.ndim
        if nd >= 2 and sorted((dim0 % nd, dim1 % nd)) == [nd - 2, nd - 1]:
            return self.t()
        return super().transpose(dim0, dim1)

    def open(self, b_share: torch.Tensor) -> torch.Tensor:
        """The revealed delta = y - b of a Beaver product with this operand
        y, summed over both parties: one pass, no expansion."""
        return seed_expand.open(self.share0, self.key, self.transposed, b_share)

    def __repr__(self):
        return (f"SeedCompressedArithmetic(shape={self.shape}, scale={self.encoder.scale}"
                f"{', transposed' if self.transposed else ''})")
