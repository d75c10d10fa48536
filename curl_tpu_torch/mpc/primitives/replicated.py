"""Replicated secret sharing (RSS, ABY3-style), the 3-party protocol.

Counterpart of ``curl_tpu/mpc/primitives/replicated.py``. Each party
passes its share one step around the ring (``comm.ppermute``, a roll of the
party axis), so that party p holds its own share and party p - 1's; a
bilinear op is then computed locally,

    z_p = x_p y_p + x_p y_{p-1} + x_{p-1} y_p,

whose sum over the parties is x y, and re-randomized by a PRZS. A matmul's
three products are one ``ring.matmul_acc`` launch of three pairs (one
ring-mm launch on CUDA), a convolution's one ``ring.conv_acc``; the sum is
the JAX package's three ring products mod 2^64. Selected with
``mpc.protocol: replicated``. Truncation is the ABY3 two-share trick,
exact only for 3 parties (replicated.py:109-135). The LUTs, EGK, AND and
B2A use reveals and provider tuples only and are Beaver's.
"""

from __future__ import annotations

import torch

from ... import comm
from ... import random as rng
from ... import ring
from .arithmetic import ArithmeticSharedTensor
from .beaver import _product_pairs, _ring_sum
from .party import lift


def _bilinear(op, x, y, **kwargs):
    """x1 y1 + x1 y2 + x2 y1 with (x2, y2) the previous party's shares, plus
    a PRZS: two ring passes, no reveal."""
    x1, y1 = x.share, y.share
    x2, y2 = comm.ppermute(x.share, shift=1), comm.ppermute(y.share, shift=1)
    terms = [(x1, y1), (x1, y2), (x2, y1)]
    if op == "mul":
        nd = len(torch.broadcast_shapes(x.shape, y.shape))
        z = sum(lift(a, nd) * lift(b, nd) for a, b in terms)
    else:
        pairs, back = _product_pairs(op, x.ndim, y.ndim, terms)
        z = back(_ring_sum(op, pairs, kwargs))
    return ArithmeticSharedTensor(z + rng.przs_arithmetic(tuple(z.shape[1:])), x.encoder)


def mul(x, y):
    return _bilinear("mul", x, y)


def matmul(x, y):
    return _bilinear("matmul", x, y)


def conv1d(x, y, **kwargs):
    return _bilinear("conv1d", x, y, **kwargs)


def conv2d(x, y, **kwargs):
    return _bilinear("conv2d", x, y, **kwargs)


def conv_transpose1d(x, y, **kwargs):
    return _bilinear("conv_transpose1d", x, y, **kwargs)


def conv_transpose2d(x, y, **kwargs):
    return _bilinear("conv_transpose2d", x, y, **kwargs)


def square(x):
    """x1^2 + 2 x1 x2 plus a PRZS: one ring pass."""
    x1 = x.share
    x2 = comm.ppermute(x.share, shift=1)
    z = x1 * x1 + 2 * x1 * x2
    return ArithmeticSharedTensor(z + rng.przs_arithmetic(x.shape), x.encoder)


def truncate(x, y: int):
    """3-party ABY3 truncation (replicated.py:109-135): after one ring pass
    party 1 holds x0 + x1 and truncates it, party 2 truncates its own
    share, party 0 holds 0; a PRZS restores three random shares."""
    if comm.get_world_size() != 3:
        raise NotImplementedError("replicated truncation requires 3 parties")
    nbr = comm.ppermute(x.share, shift=1)
    t_sum = ring.trunc_div_signed(x.share[1] + nbr[1], y)
    t_own = ring.trunc_div_signed(x.share[2], y)
    share = torch.stack([torch.zeros_like(t_sum), t_sum, t_own])
    return ArithmeticSharedTensor(share + rng.przs_arithmetic(x.shape), x.encoder)


# The LUT, EGK, AND and B2A protocols use reveals and provider tuples only:
# Beaver's, as the JAX package re-exports them.
from .beaver import (  # noqa: E402,F401
    AND,
    B2A_single_bit,
    egk_trunc_pr,
    evaluate_bior_lut,
    evaluate_embed,
    evaluate_embed_chunked,
    evaluate_lut,
    wraps,
)
