"""Dropout from a private uniform mask (counterpart of
``curl_tpu/functions/dropout.py``): the mask's bits come from the port's
Philox streams (``MPCTensor.rand``)."""

from __future__ import annotations

from ..mpc.mpc import MPCTensor


def dropout(self, p=0.5, training=True, inplace=False):
    """Each element kept with probability 1 - p and scaled by 1 / (1 - p),
    where ``training`` (dropout.py:11-21)."""
    if p == 0.0:
        return self
    if p == 1.0:
        return self - self
    assert 0.0 < p < 1.0, "dropout probability has to be between 0 and 1"
    if not training:
        return self.clone()
    keep = MPCTensor.rand(*self.size()).gt(p)
    return self.div(1 - p).mul(keep)


MPCTensor.dropout = dropout
