"""Integer powers, pos_pow, polynomials and norms (counterpart of
``curl_tpu/functions/power.py``). Installed on MPCTensor."""

from __future__ import annotations

import numpy as np

from ..mpc.mpc import MPCTensor


def pow(self, p):
    """Integer exponent by repeated squaring (power.py:14)."""
    if isinstance(p, float) and int(p) == p:
        p = int(p)
    if not isinstance(p, int):
        raise TypeError("pow must take an integer exponent. For non-integer powers, use "
                        "pos_pow with positive-valued base.")
    if p < -1:
        return self.reciprocal().pow(-p)
    if p == -1:
        return self.reciprocal()
    if p == 0:
        from .approximations import public_constant

        return public_constant(self, 1.0)
    if p == 1:
        return self.clone()
    if p == 2:
        return self.square()
    if p % 2 == 0:
        return self.square().pow(p // 2)
    return self.square().mul(self).pow((p - 1) // 2)


def pos_pow(self, p):
    """x^p = exp(p log x) for positive x; an integer p by ``pow``
    (power.py:38)."""
    if isinstance(p, int) or (isinstance(p, float) and int(p) == p):
        return self.pow(p)
    return self.log().mul(p).exp()


def polynomial(self, coeffs, func="mul"):
    """sum_i coeffs[i] x^(i+1) (power.py:45): the powers built by doubling
    the stack of terms, then one public product and a sum."""
    coeffs = np.asarray(coeffs, dtype=np.float64)
    if coeffs.ndim != 1:
        raise ValueError("coefficients must be 1-D")
    if coeffs.shape[0] == 1:
        return self.mul(float(coeffs[0]))
    terms = MPCTensor.stack([self, self.square()])
    while terms.size(0) < coeffs.shape[0]:
        highest = terms.index_select(0, [terms.size(0) - 1])
        terms = MPCTensor.cat([terms, getattr(terms, func)(highest)])
    terms = terms[: coeffs.shape[0]]
    c = coeffs.reshape((-1,) + (1,) * (terms.dim() - 1))
    return terms.mul(c).sum(axis=0)


def norm(self, p="fro", dim=None, keepdim=False):
    """p-norms (power.py:68)."""
    if p == "fro":
        p = 2
    if not isinstance(p, (int, float)):
        raise ValueError(f"Improper value p ({p}) for p-norm")
    assert p >= 1, "p-norm requires p >= 1"

    def total(t):
        return t.sum() if dim is None else t.sum(axis=dim, keepdim=keepdim)

    if p == 1:
        return total(self.abs())
    if p == 2:
        return total(self.square()).sqrt()
    if p == float("inf"):
        a = self.abs()
        return a.max() if dim is None else a.max(dim=dim, keepdim=keepdim)[0]
    return total(self.abs().pos_pow(p)).pos_pow(1 / p)


for _name, _fn in (("pow", pow), ("pos_pow", pos_pow), ("polynomial", polynomial),
                   ("norm", norm)):
    setattr(MPCTensor, _name, _fn)
