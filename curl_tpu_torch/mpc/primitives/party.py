"""The explicit party axis: helpers shared by the share types.

A share tensor is ``(P, *shape)``; a public tensor has no party axis. Torch
broadcasting aligns trailing dims, so a public operand whose rank does not
exceed the share's per-party rank lines up with the per-party dims and
never with the party axis. ``lift`` pads a share's per-party rank with
leading 1s so that this always holds, for share-share and share-public
operations alike.
"""

from __future__ import annotations

import numbers

import torch

from ... import comm


def lift(share: torch.Tensor, ndim: int) -> torch.Tensor:
    """(P, *s) -> (P, 1, ..., 1, *s) with per-party rank ``ndim``."""
    extra = ndim - (share.dim() - 1)
    if extra <= 0:
        return share
    return share.reshape((share.shape[0],) + (1,) * extra + tuple(share.shape[1:]))


def rank0(pub, shape=(), src: int = 0, ndim: int = 0) -> torch.Tensor:
    """(P, ...) share in which party ``src`` holds ``pub`` and every other
    party 0: the public term of a protocol, added by one party only. A
    Python int fills ``shape``; a tensor keeps its shape, with leading 1s
    up to a per-party rank of ``ndim``."""
    if isinstance(pub, numbers.Integral):
        out = torch.zeros((comm.get_world_size(),) + tuple(shape), dtype=torch.int64,
                          device=comm.get_device())
        out[src] = int(pub)
        return out
    return comm.rank_mask(src, max(ndim, pub.dim())) * pub

