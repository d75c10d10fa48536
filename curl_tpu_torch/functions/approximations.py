"""Nonlinear functions over MPC: the methods the shipped config selects.

Counterpart of ``curl_tpu/functions/approximations.py`` for this slice:
exp by the ``limit`` method, reciprocal by the ``haar`` LUT, inv_sqrt by the
``tailored_haar`` LUTs, gelu by the ``bior`` LUT, and softmax (with an
optional public mask) with Newton refinement of the denominator
(``softmax_recip_refine``). Same round
structure and truncation choices as the JAX package; other methods are a
later slice and raise.
"""

from __future__ import annotations

import torch

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
    """1/sqrt(x) by two haar tables split at x = 1 (approximations.py:232).

    Table 0 (x < 1) is read where its own truncated index lies inside it,
    table 1 elsewhere. The reference selects table 0 by x < 1 instead: for
    x within one cell below 1 the probabilistic truncation can round the
    index up to the table's size, which the LUT wraps to cell 0 (106.6 for
    about 1.0), and at batch 8 a GPT-2 forward's LayerNorms meet such a row
    nearly every run (ROADMAP Queue C). Selecting by the index is the same
    one comparison on a tensor of the same shape, so rounds and bytes are
    the reference's; values differ only within one cell of x = 1."""
    method = cfg.functions.inv_sqrt_method
    if method != "tailored_haar":
        raise _not_ported("inv_sqrt", method)
    F = cfg.functions
    prec = cfg.encoder.precision_bits
    luts = LookupTables().LUTs
    truncation_0 = F.inv_sqrt_tailored_0_lut_max_bits + prec - F.inv_sqrt_tailored_0_haar_size_bits
    truncation_1 = F.inv_sqrt_tailored_1_lut_max_bits + prec - F.inv_sqrt_tailored_1_haar_size_bits
    index_0 = _trunc_lut(self, truncation_0)
    y_0 = index_0.evaluate_lut(luts["inv_sqrt_tailored_haar_0"])
    y_1 = _trunc_lut(self, truncation_1).evaluate_lut(luts["inv_sqrt_tailored_haar_1"])
    # index_0 keeps x's encoding: it lies inside table 0 iff its decoded
    # value is below 2^(lut_max_bits - truncation)
    b = index_0 < 2.0 ** (F.inv_sqrt_tailored_0_lut_max_bits - truncation_0)
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


def softmax(self, dim=-1, mask=None):
    """max-shift -> exp(all-neg) -> refined reciprocal of the sum
    (approximations.py:694-749).

    ``mask``: an optional public 0/1 tensor broadcastable to self (a causal
    attention mask). Its handling is local: masked lanes are pinned
    publicly to -2^(compare_bits - 3 - precision), the most negative value
    inside the comparison envelope, before the max, and the numerator is
    zeroed on them, so they get probability 0. A host array is copied to
    the device once (``ring.host_constant``)."""
    if self.dim() == 0 or self.size(dim) == 1:
        raise NotImplementedError("softmax over a single element is not ported yet")
    if mask is not None:
        from ..mpc.mpc import _compare_bits
        from ..mpc.primitives.arithmetic import _public_tensor

        mask = _public_tensor(mask, constant=True).to(torch.float64)
        neg = -float(2 ** (_compare_bits() - 3 - self.encoder.precision_bits))
        maximum_value = self.mul(mask).add((1.0 - mask) * neg).max_value(dim, keepdim=True)
    else:
        maximum_value = self.max_value(dim, keepdim=True)
    logits = self - maximum_value
    with cfg.temp_override({"functions.exp_all_neg": True}):
        numerator = logits.exp()
    if mask is not None:
        numerator = numerator.mul(mask)
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
