"""Comparison / sign logic from the _ltz primitive (counterpart of
``curl_tpu/functions/logic.py``). Installed on MPCTensor."""

from __future__ import annotations

from ..mpc.mpc import MPCTensor


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


def where(self, condition, y):
    """condition * self + (1 - condition) * y for a private condition."""
    if not isinstance(condition, MPCTensor):
        raise NotImplementedError("where with a public condition is not ported yet")
    y_masked = (-(condition) + 1).mul(y)
    return self.mul(condition).add(y_masked)


for _name, _fn in (
    ("ge", ge), ("gt", gt), ("le", le), ("lt", lt), ("sign", sign),
    ("abs", abs), ("relu", relu), ("where", where),
):
    setattr(MPCTensor, _name, _fn)
