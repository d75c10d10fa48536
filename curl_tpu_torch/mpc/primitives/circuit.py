"""Constant-round Set-Propagate-Kill adder circuits on 64-bit words.

Counterpart of ``curl_tpu/mpc/primitives/circuit.py`` (the parts the port
runs: the SPK prefix, the adder and the equality AND tree). At each of log2(width) levels one
Beaver AND updates the S and P lanes together (they are stacked so both
ANDs share one reveal); fanning values along the prefix arrows is a plain
multiply in the ring of bits. The masks are the JAX package's, folded into
the int64 range.
"""

from __future__ import annotations

import torch

from ... import ring

_BITS = 64
_LOG_BITS = 6


def _level_masks():
    """Level-i mask: ones at the prefix-arrow sources, lanes
    (2^i - 1) + k * 2^(i+1)."""
    masks = []
    for i in range(_LOG_BITS):
        m = 0
        for start in range((1 << i) - 1, 64, 1 << (i + 1)):
            m |= 1 << start
        masks.append(m)
    return masks


_MASKS_U = _level_masks()
_MULTIPLIERS_U = [((1 << ((1 << i) + 1)) - 2) % (1 << 64) for i in range(_LOG_BITS)]
_OUT_MASKS_U = [(m * mult) % (1 << 64) for m, mult in zip(_MASKS_U, _MULTIPLIERS_U)]

_MASKS = [ring.scalar(m) for m in _MASKS_U]
_MULTIPLIERS = [ring.scalar(m) for m in _MULTIPLIERS_U]
_OUT_MASKS = [ring.scalar(m) for m in _OUT_MASKS_U]


def _log2(width):
    return {16: 4, 32: 5, 64: 6}[width]


def _boundary_clear(width):
    """Clear-mask for carries crossing a packed-segment boundary."""
    m = (1 << 64) - 1
    for j in range(width, 64, width):
        m ^= 1 << j
    return ring.scalar(m)


def _spk_circuit(S, P, levels=_LOG_BITS):
    """Parallel-prefix SPK reduction over ``levels`` AND levels:
    S <- S0 ^ (P0 & S1);  P <- P0 & P1."""
    from .binary import BinarySharedTensor

    SP = BinarySharedTensor.stack([S, P])  # per-party (2, ...)
    for i in range(levels):
        not_out_mask = ring.scalar(_OUT_MASKS_U[i] ^ ((1 << 64) - 1))
        P0 = SP.with_share(SP.share[:, 1] & _OUT_MASKS[i])
        S1P1 = SP.with_share((SP.share & _MASKS[i]) * _MULTIPLIERS[i])  # fan along arrows
        update = P0 & S1P1  # one Beaver AND for both S and P lanes
        new_p = SP.share[:, 1] & not_out_mask
        SP = SP.with_share(torch.stack([SP.share[:, 0], new_p], dim=1) ^ update.share)
    return SP.with_share(SP.share[:, 0]), SP.with_share(SP.share[:, 1])


def add(x, y, width=_BITS):
    """Private addition of XOR-shared words; with width < 64 each word is
    64/width independent adders (carries across segments are cleared)."""
    S = x & y
    P = x ^ y
    carry, _ = _spk_circuit(S, P, levels=_log2(width))
    shifted = carry << 1
    if width != _BITS:
        shifted = shifted.with_share(shifted.share & _boundary_clear(width))
    return P ^ shifted


def _p_circuit(P, width=_BITS):
    """AND tree over bit lanes (circuit.py:90-99): lane k * width - 1 ends
    up set iff all ``width`` bits of segment k are 1. With width < 64 the
    shift windows stay inside each segment, so a packed word evaluates
    64 / width equalities at once."""
    shift = width // 2
    for _ in range(_log2(width)):
        P = P & (P << shift)
        shift //= 2
    return P


def eq(x, y):
    """Bitwise equality of XOR-shared words: the sign lane of the AND tree
    over ~(x ^ y) (circuit.py:128)."""
    return _p_circuit(~(x ^ y)).logical_rshift(63)
