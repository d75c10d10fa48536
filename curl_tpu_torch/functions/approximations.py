"""Nonlinear functions over MPC: the methods the shipped config selects.

Counterpart of ``curl_tpu/functions/approximations.py`` for this slice:
exp by the ``limit`` method, reciprocal by the ``haar`` LUT, inv_sqrt by the
``tailored_haar`` LUTs, gelu by the ``bior`` LUT, and softmax with Newton
refinement of the denominator (``softmax_recip_refine``). Same round
structure and truncation choices as the JAX package; other methods are a
later slice and raise.
"""

from __future__ import annotations

from ..config import cfg
from ..mpc.mpc import MPCTensor
from .luts import LookupTables


def _not_ported(kind, method):
    return NotImplementedError(f"{kind} method {method!r} is not ported yet")


def _trunc_lut(x, truncation):
    """Truncate to the LUT index per cfg.encoder.trunc_method.lut."""
    if cfg.encoder.trunc_method.lut == "crypten":
        return x.div(2 ** truncation)
    return x.egk_trunc_pr(62, truncation)


def _truncmod_lut(x, truncation):
    """(msb, lsb remainder) per cfg.encoder.trunc_method.lut."""
    if cfg.encoder.trunc_method.lut == "crypten":
        raise _not_ported("lut truncation", "crypten")
    return x.egk_truncmod_pr(62, truncation)


def exp(self):
    """exp by the limit approximation (1 + x/2^n)^(2^n) (approximations.py:96)."""
    method = cfg.functions.exp_method
    if method != "limit":
        raise _not_ported("exp", method)
    from ..kernels import fused_mul

    iters = cfg.functions.exp_iterations
    result = self.div(2 ** iters) + 1
    x = result._tensor
    if iters > 0 and fused_mul.fused_available(x):
        # the squarings as one fused pass (mpc.fused_mul = "cuda")
        return result._wrap(fused_mul.fused_square_chain_mpc(x, iters, fused_mul.square_bits(x)))
    for _ in range(iters):
        result = result.square()
    return result


def reciprocal(self):
    """1/x by the haar LUT over [0, 2^reciprocal_lut_max_bits)
    (approximations.py:181)."""
    method = cfg.functions.reciprocal_method
    if not cfg.functions.reciprocal_all_pos:
        raise _not_ported("reciprocal (signed input)", method)
    if method != "haar":
        raise _not_ported("reciprocal", method)
    F = cfg.functions
    truncation = F.reciprocal_lut_max_bits + cfg.encoder.precision_bits - F.reciprocal_haar_size_bits
    return _trunc_lut(self, truncation).evaluate_lut(LookupTables().LUTs["reciprocal_haar"])


def inv_sqrt(self):
    """1/sqrt(x) by two haar tables split at x = 1 (approximations.py:232)."""
    method = cfg.functions.inv_sqrt_method
    if method != "tailored_haar":
        raise _not_ported("inv_sqrt", method)
    F = cfg.functions
    prec = cfg.encoder.precision_bits
    luts = LookupTables().LUTs
    truncation_0 = F.inv_sqrt_tailored_0_lut_max_bits + prec - F.inv_sqrt_tailored_0_haar_size_bits
    truncation_1 = F.inv_sqrt_tailored_1_lut_max_bits + prec - F.inv_sqrt_tailored_1_haar_size_bits
    y_0 = _trunc_lut(self, truncation_0).evaluate_lut(luts["inv_sqrt_tailored_haar_0"])
    y_1 = _trunc_lut(self, truncation_1).evaluate_lut(luts["inv_sqrt_tailored_haar_1"])
    b = self < 1
    return b * y_0 + (-b + 1) * y_1


def gelu(self):
    """gelu = relu - LUT(relu - gelu) by the bior LUT (approximations.py:592)."""
    method = cfg.functions.gelu_method
    if method != "bior":
        raise _not_ported("gelu", method)
    F = cfg.functions
    sgn = self.sign()
    absx = sgn * self
    drelu = -(self._ltz()) + 1
    relu = self * drelu
    truncation = F.gelu_lut_max_bits + cfg.encoder.precision_bits - F.gelu_bior_size_bits
    msb, lsb = _truncmod_lut(absx, truncation)
    lut = msb.evaluate_bior_lut(LookupTables().LUTs["gelu_bior"], lsb, truncation)
    check = absx < 2 ** F.gelu_lut_max_bits
    return relu - lut * check


def softmax(self, dim=-1):
    """max-shift -> exp(all-neg) -> refined reciprocal of the sum
    (approximations.py:694-749)."""
    if self.dim() == 0 or self.size(dim) == 1:
        raise NotImplementedError("softmax over a single element is not ported yet")
    maximum_value = self.max_value(dim, keepdim=True)
    logits = self - maximum_value
    with cfg.temp_override({"functions.exp_all_neg": True}):
        numerator = logits.exp()
    denominator = numerator.sum(axis=dim, keepdim=True)
    with cfg.temp_override({"functions.reciprocal_all_pos": True}):
        inv_denominator = denominator.reciprocal()
    # Newton refinement r <- r (2 - s r) of the LUT reciprocal
    for _ in range(int(cfg.functions.softmax_recip_refine)):
        inv_denominator = (
            inv_denominator + inv_denominator - denominator.mul(inv_denominator.square())
        )
    return numerator * inv_denominator


for _name, _fn in (
    ("exp", exp), ("reciprocal", reciprocal), ("inv_sqrt", inv_sqrt),
    ("gelu", gelu), ("softmax", softmax),
):
    setattr(MPCTensor, _name, _fn)
