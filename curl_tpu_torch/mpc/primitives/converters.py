"""A2B / B2A share conversion (counterpart of
``curl_tpu/mpc/primitives/converters.py``).

A2B: each party XOR-shares its own arithmetic share; the P binary tensors
are summed with the SPK adder tree. B2A: bit-decompose, convert every bit
with one batched B2A_single_bit reveal, weighted-sum; ``bits=1`` for
comparison outputs.
"""

from __future__ import annotations

from ... import comm, ring
from ...encoder import FixedPointEncoder
from . import beaver
from .arithmetic import ArithmeticSharedTensor
from .binary import BinarySharedTensor


def A2B(arithmetic_tensor: ArithmeticSharedTensor, width=64) -> BinarySharedTensor:
    n = comm.get_world_size()
    if n == 1:
        return BinarySharedTensor(arithmetic_tensor.share, arithmetic_tensor.encoder)
    parts = [
        BinarySharedTensor.encrypt(arithmetic_tensor.share, src=i, per_party=True)
        for i in range(n)
    ]
    binary_tensor = BinarySharedTensor.stack(parts).sum(axis=0, width=width)
    return BinarySharedTensor(binary_tensor.share, arithmetic_tensor.encoder)


def B2A(binary_tensor: BinarySharedTensor, precision=None, bits=None) -> ArithmeticSharedTensor:
    bits = 64 if bits is None else bits
    if bits == 1:
        arithmetic_tensor = beaver.B2A_single_bit(binary_tensor & 1)
    else:
        stacked = BinarySharedTensor.stack(
            [binary_tensor.logical_rshift(i) for i in range(bits)]
        ) & 1
        arithmetic_bits = beaver.B2A_single_bit(stacked)
        multiplier = ring.constant(
            [ring.scalar(1 << i) for i in range(bits)], stacked.share.device
        ).reshape((bits,) + (1,) * binary_tensor.ndim)
        share = (arithmetic_bits.share * multiplier).sum(dim=1)
        arithmetic_tensor = ArithmeticSharedTensor(share, FixedPointEncoder(0))

    encoder = FixedPointEncoder(precision)
    scale = encoder.scale // max(binary_tensor.encoder.scale, 1)
    return ArithmeticSharedTensor(arithmetic_tensor.share * max(scale, 1), encoder)
