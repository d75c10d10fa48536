"""Private weighted index (counterpart of the part of
``curl_tpu/functions/sampling.py`` the max reduction uses)."""

from __future__ import annotations

from ..mpc.mpc import MPCTensor


def weighted_index(self, dim=None):
    """Random one-hot with weights self along dim (reference sampling.py:60)."""
    if dim is None:
        return weighted_index(self.flatten(), dim=0).view(self.size())
    x = self.cumsum(dim)
    max_weight = x.index_select(dim, [x.size(dim) - 1])
    r = MPCTensor.rand(*max_weight.size()) * max_weight

    gt = x.gt(r)
    shifted = gt.roll(1, dims=dim)
    # zero the wrapped-around first slot
    share = shifted.share.clone()
    share.narrow(dim + 1 if dim >= 0 else dim, 0, 1).zero_()
    shifted = MPCTensor(type(shifted._tensor)(share, shifted.encoder), shifted.ptype)
    return gt - shifted


MPCTensor.weighted_index = weighted_index
