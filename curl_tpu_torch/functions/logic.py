"""Comparison / sign logic from the _ltz primitive (counterpart of
``curl_tpu/functions/logic.py``). Installed on MPCTensor."""

from __future__ import annotations

import torch

from ..mpc.mpc import MPCTensor
from ..mpc.primitives.arithmetic import _public_tensor


def ge(self, y):
    """self >= y  =  1 - (self < y)"""
    return -(self.lt(y)) + 1


def gt(self, y):
    """self > y  =  ltz(y - self)"""
    return (self.neg() + y)._ltz()


def le(self, y):
    return -(self.gt(y)) + 1


def lt(self, y):
    return (self - y)._ltz()


def sign(self):
    """1 for >= 0, -1 for < 0."""
    return -(self._ltz().mul(2)) + 1


def abs(self):
    return self.mul(self.sign())


def relu(self):
    return self.mul(self.ge(0))


def drelu(self):
    """1 for >= 0, 0 for < 0 (logic.py:75)."""
    return -(self._ltz()) + 1


def hardtanh(self, min_value=-1, max_value=1):
    """clip(self, min, max) as relu(x - min) - relu(x - max) + min, both
    clips in one stacked comparison (logic.py:79)."""
    inter = MPCTensor.stack([self - min_value, self - max_value]).relu()
    return inter[0].sub(inter[1]).add(min_value)


def where(self, condition, y):
    """condition * self + (1 - condition) * y (logic.py:86): a private
    condition by two products, a public one (0/1, broadcastable) by public
    products; y private or public."""
    if isinstance(condition, MPCTensor):
        y_masked = (-(condition) + 1).mul(y)
        return self.mul(condition).add(y_masked)
    cond = _public_tensor(condition, constant=True).to(torch.float64)
    if isinstance(y, MPCTensor):
        y_masked = y.mul(1 - cond)
    else:
        y_masked = _public_tensor(y, constant=True).to(torch.float64) * (1 - cond)
    return self.mul(cond).add(y_masked)


for _name, _fn in (
    ("ge", ge), ("gt", gt), ("le", le), ("lt", lt), ("sign", sign),
    ("abs", abs), ("relu", relu), ("drelu", drelu), ("hardtanh", hardtanh), ("where", where),
):
    setattr(MPCTensor, _name, _fn)
