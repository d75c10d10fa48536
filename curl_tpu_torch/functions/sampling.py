"""Private sampling: randn (Box-Muller on private uniforms), bernoulli and
the weighted index and sample (counterpart of
``curl_tpu/functions/sampling.py``). Every uniform comes from
``MPCTensor.rand``, bits drawn from the port's Philox streams."""

from __future__ import annotations

import math

from ..mpc.mpc import MPCTensor


def randn(cls, *sizes):
    """Normal samples by Box-Muller on private uniforms (sampling.py:16-39):
    r = sqrt(-2 ln u1), then r sin and r cos of 2 pi (u2 - 1/2)."""
    u = cls.rand(*sizes).flatten()
    numel = math.prod(sizes)
    odd = numel % 2 == 1
    if odd:
        u = cls.cat([u, cls.rand(1)])
        numel += 1
    n = numel // 2
    r = u[:n].log(input_in_01=True).mul(-2).sqrt()
    cos, sin = u[n:].sub(0.5).mul(6.28318531).cossin()
    z = cls.cat([r.mul(sin), r.mul(cos)])
    if odd:
        z = z[1:]
    return z.view(*sizes)


def bernoulli(self):
    """Element i is 1 with probability self_i (sampling.py:42-44)."""
    return self.gt(MPCTensor.rand(*self.size()))


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


def weighted_sample(self, dim=None):
    """(the weights' sample, its one-hot) (sampling.py:73-76)."""
    indices = weighted_index(self, dim)
    return self.mul(indices).sum(dim), indices


MPCTensor.randn = classmethod(randn)
MPCTensor.bernoulli = bernoulli
MPCTensor.weighted_index = weighted_index
MPCTensor.weighted_sample = weighted_sample
