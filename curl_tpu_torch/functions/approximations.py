"""Nonlinear functions over MPC: Curl's wavelet-LUT methods and the
iterative ones (counterpart of ``curl_tpu/functions/approximations.py``).

Every function and method of the JAX package: exp (``limit``, ``split``,
``haar``, ``bior``), log (``haar``, ``bior``, ``iter``), reciprocal
(``haar``, ``bior``, ``NR``, ``log``), inv_sqrt (``haar``, ``bior``,
``tailored_haar``, ``NR``), sqrt, cos/sin (``haar``, ``bior``, the
``*-lut-only`` tables, ``NR`` by ``_eix``), sigmoid and tanh (``haar``,
``bior``, ``*-lut-only``, ``reciprocal``, ``chebyshev``), erf (the LUTs and
``Taylor``), gelu (the LUTs and ``erf``), silu (the LUTs and ``sigmoid``),
softmax (with an optional public mask) and log_softmax. Each method takes
the same truncation (``_trunc_lut`` / ``_truncmod_lut``, EGK or crypten per
``cfg.encoder.trunc_method.lut``) and the same sequence of protocol calls
as the reference, so its rounds and bytes are curl_tpu's. Where the
reference is wrong off the shipped config's path, the port computes what
it computes (ROADMAP Queue C): the lut-only trig tables, the lut-only tanh
offset, the overflowing signed exp tables, the ``split`` exp and erf's
Taylor series on negative inputs. One fault is fixed here: inv_sqrt's
``tailored_haar`` selects its table by index (below).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import cfg
from ..mpc.mpc import MPCTensor
from ..mpc.primitives.arithmetic import ArithmeticSharedTensor
from ..encoder import FixedPointEncoder
from .luts import LookupTables

_LUT_ONLY = ("haar-lut-only", "bior-lut-only")


def _trunc_lut(x, truncation):
    """Truncate to the LUT index per cfg.encoder.trunc_method.lut."""
    if cfg.encoder.trunc_method.lut == "crypten":
        return x.div(2 ** truncation)
    return x.egk_trunc_pr(62, truncation)


def _truncmod_lut(x, truncation):
    """(msb, lsb remainder) per cfg.encoder.trunc_method.lut: the crypten
    one is the local truncation and its public remainder (``divmod``)."""
    if cfg.encoder.trunc_method.lut == "crypten":
        return x.divmod(2 ** truncation)
    return x.egk_truncmod_pr(62, truncation)


def _haar(x, max_bits, size_bits, table):
    """One haar table over [0, 2^max_bits) with 2^size_bits cells: the
    index truncation, then one LUT evaluation."""
    truncation = max_bits + cfg.encoder.precision_bits - size_bits
    return _trunc_lut(x, truncation).evaluate_lut(LookupTables().LUTs[table])


def _bior(x, max_bits, size_bits, table):
    """Two bior banks, linearly interpolated on the truncation remainder."""
    truncation = max_bits + cfg.encoder.precision_bits - size_bits
    msb, lsb = _truncmod_lut(x, truncation)
    return msb.evaluate_bior_lut(LookupTables().LUTs[table], lsb, truncation)


def _lut(method, x, max_bits, haar_bits, bior_bits, name):
    """``name``'s haar or bior table (a lut-only method reads the
    ``_lut_only`` table of its kind)."""
    suffix = "_lut_only" if method in _LUT_ONLY else ""
    if method.startswith("haar"):
        return _haar(x, max_bits, haar_bits, f"{name}_haar{suffix}")
    return _bior(x, max_bits, bior_bits, f"{name}_bior{suffix}")


def _nexp_lut(x, method):
    """exp(-x) for x >= 0 (approximations.py:53)."""
    F = cfg.functions
    luts = LookupTables().LUTs
    if method == "split":
        # x -> c = c1 * size + c0; exp(-x) = nexp_high[c1] * nexp_low[c0]
        precision = 2 ** cfg.encoder.precision_bits
        size = F.exp_neg_lut_size
        xs = x.div(precision / 2 ** 4 / size)
        d = xs < 1
        xs_raw = MPCTensor(ArithmeticSharedTensor(xs.share, FixedPointEncoder(0)), xs.ptype)
        c = d * xs_raw + (-d + 1) * (precision - 1)
        t0 = c.evaluate_lut(luts["nexp_low"])
        t1 = c.div(size).evaluate_lut(luts["nexp_high"])
        return t0 * t1
    if method in ("haar", "bior"):
        check = x < 2 ** F.exp_lut_max_bits
        # the reference truncates by the bior table's size under haar too
        lut = _lut(method, x, F.exp_lut_max_bits, F.exp_bior_size_bits, F.exp_bior_size_bits,
                   "nexp")
        return check * lut
    raise ValueError(f"Invalid method {method} for nexp function")


def exp(self):
    """exp by a LUT or the limit (1 + x/2^n)^(2^n) (approximations.py:96).
    Under mpc.fused_mul = "cuda" the limit's squarings are one fused pass."""
    F = cfg.functions
    method = F.exp_method
    if method in ("split", "haar", "bior"):
        if F.exp_all_neg:
            return _nexp_lut(-self, method)
        if method == "split":
            raise ValueError("split exp requires exp_all_neg")
        return _lut(method, self, F.exp_lut_max_bits, F.exp_haar_size_bits,
                    F.exp_bior_size_bits, "exp")
    if method != "limit":
        raise ValueError(f"Invalid method {method} given for exp function")
    from ..kernels import fused_mul

    iters = F.exp_iterations
    result = self.div(2 ** iters) + 1
    x = result._tensor
    if iters > 0 and fused_mul.fused_available(x):
        return result._wrap(fused_mul.fused_square_chain_mpc(x, iters, fused_mul.square_bits(x)))
    for _ in range(iters):
        result = result.square()
    return result


def log(self, input_in_01=False):
    """log by a LUT or Householder iterations (approximations.py:130).
    ``input_in_01``: ln(u) = ln(a u) - ln(a), with a = 2^log_lut_max_bits - 1
    under the LUT methods (inside the table, and u = 1 off its edge) and
    100 under ``iter``."""
    F = cfg.functions
    if input_in_01:
        if F.log_method in ("haar", "bior"):
            a = float(2 ** F.log_lut_max_bits) - 1.0
        else:
            a = 100.0
        return log(self.mul(a)) - math.log(a)
    method = F.log_method
    if method in ("haar", "bior"):
        return _lut(method, self, F.log_lut_max_bits, F.log_haar_size_bits,
                    F.log_bior_size_bits, "log")
    if method == "iter":
        term1 = self.div(120)
        term2 = exp(self.mul(2).add(1.0).neg()).mul(20)
        y = term1 - term2 + 3.0
        with cfg.temp_override({"functions.exp_iterations": F.log_exp_iterations}):
            for _ in range(F.log_iterations):
                h = -(self * exp(-y)) + 1
                y = y - h.polynomial([1 / (i + 1) for i in range(F.log_order)])
        return y
    raise ValueError(f"Invalid method {method} given for log function")


def reciprocal(self, input_in_01=False):
    """1/x by a LUT, Newton-Raphson or exp(-log x) (approximations.py:181);
    a signed input by its sign and the reciprocal of |x|."""
    F = cfg.functions
    pos_override = {"functions.reciprocal_all_pos": True}
    if input_in_01:
        with cfg.temp_override(pos_override):
            return reciprocal(self.mul(64)).mul(64)
    method = F.reciprocal_method
    if not F.reciprocal_all_pos:
        sgn = self.sign()
        pos = sgn * self
        with cfg.temp_override(pos_override):
            return sgn * reciprocal(pos)
    if method in ("haar", "bior"):
        return _lut(method, self, F.reciprocal_lut_max_bits, F.reciprocal_haar_size_bits,
                    F.reciprocal_bior_size_bits, "reciprocal")
    if method == "NR":
        if F.reciprocal_initial is None:
            result = (self.mul(-2).add(1.0)).exp().mul(3) + 0.003
        else:
            result = self.mul(0).add(float(F.reciprocal_initial))
        for _ in range(F.reciprocal_nr_iters):
            result = result + result - result.square().mul(self)
        return result
    if method == "log":
        with cfg.temp_override({"functions.log_iterations": F.reciprocal_log_iters}):
            return exp(-log(self))
    raise ValueError(f"Invalid method {method} given for reciprocal function")


def inv_sqrt(self):
    """1/sqrt(x) by LUTs or Newton-Raphson (approximations.py:232).

    ``tailored_haar`` reads table 0 (x < 1) where its own truncated index
    lies inside it, table 1 elsewhere. The reference selects table 0 by
    x < 1 instead: for x within one cell below 1 the probabilistic
    truncation can round the index up to the table's size, which the LUT
    wraps to cell 0 (106.6 for about 1.0), and at batch 8 a GPT-2 forward's
    LayerNorms meet such a row nearly every run (ROADMAP Queue C).
    Selecting by the index is the same one comparison on a tensor of the
    same shape, so rounds and bytes are the reference's; values differ
    only within one cell of x = 1."""
    F = cfg.functions
    method = F.inv_sqrt_method
    if method in ("haar", "bior"):
        return _lut(method, self, F.inv_sqrt_lut_max_bits, F.inv_sqrt_haar_size_bits,
                    F.inv_sqrt_bior_size_bits, "inv_sqrt")
    if method == "tailored_haar":
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
    if method == "NR":
        if F.sqrt_nr_initial is None:
            y = exp(self.div(2).add(0.2).neg()).mul(2.2).add(0.2)
            y = y - self.div(1024)
        else:
            y = self.mul(0).add(float(F.sqrt_nr_initial))
        for _ in range(F.sqrt_nr_iters):
            y = y.mul(-(self * y.square()) + 3).div(2)
        return y
    raise ValueError(f"Invalid method {method} given for inv_sqrt function")


def sqrt(self):
    """sqrt by a LUT or x * inv_sqrt(x) (approximations.py:285)."""
    F = cfg.functions
    method = F.sqrt_method
    if method in ("haar", "bior"):
        return _lut(method, self, F.sqrt_lut_max_bits, F.sqrt_haar_size_bits,
                    F.sqrt_bior_size_bits, "sqrt")
    if method == "NR":
        return inv_sqrt(self).mul(self)
    raise ValueError(f"Invalid method {method} given for sqrt function")


def _eix(self):
    """(cos x, sin x) by repeated squaring of e^(ix/2^n)
    (approximations.py:310)."""
    iterations = cfg.functions.trig_iterations
    im = self.div(2 ** iterations)
    re = -(im.square()) + 1
    im = im * 2
    for _ in range(iterations - 1):
        a2 = re.square()
        b2 = im.square()
        im = im.mul(re).mul(2)
        re = a2 - b2
    return re, im


def cossin(self):
    """(cos x, sin x) (approximations.py:326): ``haar``/``bior`` reduce |x|
    mod 2 pi onto one period's table and restore sin's sign; the lut-only
    tables span [-2^trigonometry_lut_max_bits, 2^...) directly; ``NR`` is
    ``_eix``. ``bior-lut-only`` returns the sin table's value first, as the
    reference does."""
    F = cfg.functions
    method = F.trigonometry_method
    if method in ("haar", "bior"):
        sgn = self.sign()
        x = sgn * self
        x = x * (1.0 / (2 * np.pi))
        x = x.mod(2 ** cfg.encoder.precision_bits)
        if method == "haar":
            truncation = cfg.encoder.precision_bits - F.trigonometry_haar_size_bits
            msb = _trunc_lut(x, truncation)
            luts = LookupTables().LUTs
            cos_r = msb.evaluate_lut(luts["cos_haar"])
            sin_r = msb.evaluate_lut(luts["sin_haar"])
        else:
            truncation = cfg.encoder.precision_bits - F.trigonometry_bior_size_bits
            msb, lsb = _truncmod_lut(x, truncation)
            luts = LookupTables().LUTs
            cos_r = msb.evaluate_bior_lut(luts["cos_bior"], lsb, truncation)
            sin_r = msb.evaluate_bior_lut(luts["sin_bior"], lsb, truncation)
        return cos_r, sgn * sin_r
    if method in _LUT_ONLY:
        x = self + 2 ** F.trigonometry_lut_max_bits
        luts = LookupTables().LUTs
        if method == "haar-lut-only":
            truncation = (F.trigonometry_lut_max_bits + cfg.encoder.precision_bits
                          - F.trigonometry_haar_size_bits)
            msb = _trunc_lut(x, truncation)
            return (msb.evaluate_lut(luts["cos_haar_lut_only"]),
                    msb.evaluate_lut(luts["sin_haar_lut_only"]))
        truncation = (F.trigonometry_lut_max_bits + cfg.encoder.precision_bits
                      - F.trigonometry_bior_size_bits)
        msb, lsb = _truncmod_lut(x, truncation)
        return (msb.evaluate_bior_lut(luts["sin_bior_lut_only"], lsb, truncation),
                msb.evaluate_bior_lut(luts["cos_bior_lut_only"], lsb, truncation))
    if method == "NR":
        return _eix(self)
    raise ValueError(f"Invalid method {method} given for cossin function")


def cos(self):
    return cossin(self)[0]


def sin(self):
    return cossin(self)[1]


def sigmoid(self):
    """sigmoid (approximations.py:388)."""
    F = cfg.functions
    method = F.sigmoid_tanh_method
    if method in ("haar", "bior"):
        ltz = self._ltz()
        sgn = -(ltz.mul(2)) + 1
        absx = sgn * self
        lut = _lut(method, absx, F.sigmoid_lut_max_bits, F.sigmoid_tanh_haar_size_bits,
                   F.sigmoid_tanh_bior_size_bits, "sigmoid")
        eval_ = ltz + sgn * lut
        limit = -ltz + 1
        check = absx < 2 ** F.sigmoid_lut_max_bits - 1
        return limit + check * (eval_ - limit)
    if method in _LUT_ONLY:
        x = self + 2 ** F.sigmoid_lut_max_bits
        return _lut(method, x, F.sigmoid_lut_max_bits, F.sigmoid_tanh_haar_size_bits,
                    F.sigmoid_tanh_bior_size_bits, "sigmoid")
    if method == "chebyshev":
        return tanh(self.div(2)).div(2) + 0.5
    if method == "reciprocal":
        ltz = self._ltz()
        sgn = -(ltz.mul(2)) + 1
        pos_input = self.mul(sgn)
        denominator = pos_input.neg().exp().add(1)
        with cfg.temp_override({"functions.exp_iterations": 9,
                                "functions.reciprocal_nr_iters": 3,
                                "functions.reciprocal_all_pos": True,
                                "functions.reciprocal_initial": 0.75}):
            pos_output = denominator.reciprocal()
        return pos_output.where(-ltz + 1, -pos_output + 1)
    raise ValueError(f"Unrecognized method {method} for sigmoid")


def tanh(self):
    """tanh (approximations.py:456). The lut-only methods offset x by
    2^tanh_lut_max_bits into tables built over the sigmoid's domain, as the
    reference does (ROADMAP Queue C)."""
    F = cfg.functions
    method = F.sigmoid_tanh_method
    if method in ("haar", "bior"):
        sgn = self.sign()
        absx = sgn * self
        lut = _lut(method, absx, F.tanh_lut_max_bits, F.sigmoid_tanh_haar_size_bits,
                   F.sigmoid_tanh_bior_size_bits, "tanh")
        check = absx < 2 ** F.tanh_lut_max_bits - 1
        return sgn * (-check + 1 + lut * check)
    if method in _LUT_ONLY:
        x = self + 2 ** F.tanh_lut_max_bits
        return _lut(method, x, F.tanh_lut_max_bits, F.sigmoid_tanh_haar_size_bits,
                    F.sigmoid_tanh_bior_size_bits, "tanh")
    if method == "reciprocal":
        return sigmoid(self.mul(2)).mul(2).sub(1)
    if method == "chebyshev":
        terms = F.sigmoid_tanh_terms
        coeffs = _chebyshev_series_tanh(terms)[1::2]
        tanh_polys = _chebyshev_polynomials(self, terms)
        tanh_polys_flipped = tanh_polys.unsqueeze(-1).transpose(0, -1).squeeze(0)
        return tanh_polys_flipped.matmul(coeffs).hardtanh()
    raise ValueError(f"Unrecognized method {method} for tanh")


def _chebyshev_series_tanh(terms):
    """Chebyshev coefficients of tanh on [-1, 1] (approximations.py:512)."""
    n_samples = 2 * terms
    points = np.arange(n_samples)
    x = np.cos(np.pi * (points + 0.5) / n_samples)
    y = np.tanh(x)
    return np.array([2.0 / n_samples * np.sum(y * np.cos(np.pi * k * (points + 0.5) / n_samples))
                     for k in range(terms)])


def _chebyshev_polynomials(self, terms):
    """The odd-degree Chebyshev polynomials at x, stacked
    (approximations.py:525)."""
    if terms % 2 != 0 or terms < 6:
        raise ValueError("Chebyshev terms must be even and >= 6")
    polynomials = [self.clone()]
    y = self.square().mul(4) - 2
    z = y - 1
    polynomials.append(z.mul(self))
    for k in range(2, terms // 2):
        polynomials.append(y * polynomials[k - 1] - polynomials[k - 2])
    return MPCTensor.stack(polynomials)


def erf(self):
    """erf (approximations.py:538). ``Taylor`` takes odd powers by
    ``pos_pow``, which is exact for integer exponents, so the series is
    the reference's on every input; it diverges away from 0."""
    F = cfg.functions
    method = F.erf_method
    if method in ("haar", "bior"):
        sgn = self.sign()
        absx = sgn * self
        lut = _lut(method, absx, F.erf_lut_max_bits, F.erf_haar_size_bits,
                   F.erf_bior_size_bits, "erf")
        check = absx < 2 ** F.erf_lut_max_bits - 1
        return sgn * (-check + 1 + lut * check)
    if method in _LUT_ONLY:
        x = self + 2 ** F.erf_lut_max_bits
        return _lut(method, x, F.erf_lut_max_bits, F.erf_haar_size_bits, F.erf_bior_size_bits,
                    "erf")
    if method == "Taylor":
        output = self.clone()
        for n in range(1, F.erf_iterations + 1):
            multiplier = ((-1) ** n) / (math.factorial(n) * (2 * n + 1))
            output = output.add(self.pos_pow(2 * n + 1).mul(multiplier))
        return output.mul(2.0 / math.sqrt(math.pi))
    raise ValueError(f"Unrecognized method {method} for erf")


def gelu(self):
    """gelu = relu - LUT(relu - gelu) (approximations.py:592)."""
    F = cfg.functions
    method = F.gelu_method
    if method in ("haar", "bior"):
        sgn = self.sign()
        absx = sgn * self
        drelu = -(self._ltz()) + 1
        relu = self * drelu
        lut = _lut(method, absx, F.gelu_lut_max_bits, F.gelu_haar_size_bits,
                   F.gelu_bior_size_bits, "gelu")
        check = absx < 2 ** F.gelu_lut_max_bits
        return relu - lut * check
    if method in _LUT_ONLY:
        x = self + 2 ** F.gelu_lut_max_bits
        return _lut(method, x, F.gelu_lut_max_bits, F.gelu_haar_size_bits,
                    F.gelu_bior_size_bits, "gelu")
    if method == "erf":
        return self * ((self / math.sqrt(2)).erf() + 1) / 2
    raise ValueError(f"Unrecognized method {method} for gelu")


def silu(self):
    """silu = relu - LUT(relu - silu) (approximations.py:643)."""
    F = cfg.functions
    method = F.silu_method
    if method in ("haar", "bior"):
        sgn = self.sign()
        absx = sgn * self
        drelu = -(self._ltz()) + 1
        relu = self * drelu
        lut = _lut(method, absx, F.silu_lut_max_bits, F.silu_haar_size_bits,
                   F.silu_bior_size_bits, "silu")
        check = absx < 2 ** F.silu_lut_max_bits - 1
        return relu - lut * check
    if method in _LUT_ONLY:
        x = self + 2 ** F.silu_lut_max_bits
        return _lut(method, x, F.silu_lut_max_bits, F.silu_haar_size_bits,
                    F.silu_bior_size_bits, "silu")
    if method == "sigmoid":
        return self * sigmoid(self)
    raise ValueError(f"Unrecognized method {method} for silu")


def public_constant(x, value, mask=None):
    """A constant of x's shape (times a public mask), encrypted by party 0
    (approximations.py:704-710, 754-757; power.py:26)."""
    out = torch.full(x.shape, float(value), dtype=torch.float64, device=x.share.device)
    if mask is not None:
        from ..mpc.primitives.arithmetic import _public_tensor

        out = out * _public_tensor(mask, constant=True).to(torch.float64)
    return MPCTensor.encrypt(out, src=0)


def softmax(self, dim=-1, mask=None):
    """max-shift -> exp(all-neg) -> refined reciprocal of the sum
    (approximations.py:694); over one element, the encrypted constant 1.

    ``mask``: an optional public 0/1 tensor broadcastable to self (a causal
    attention mask). Its handling is local: masked lanes are pinned
    publicly to -2^(compare_bits - 3 - precision), the most negative value
    inside the comparison envelope, before the max, and the numerator is
    zeroed on them, so they get probability 0. A host array is copied to
    the device once (``ring.host_constant``)."""
    if self.dim() == 0 or self.size(dim) == 1:
        return public_constant(self, 1.0, mask)
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
    # Newton refinement r <- r (2 - s r) of the LUT reciprocal; 2 steps
    # where the profile has no functions.softmax_recip_refine
    # (approximations.py:740-743)
    try:
        refine = int(cfg.functions.softmax_recip_refine)
    except AttributeError:
        refine = 2
    for _ in range(refine):
        inv_denominator = (
            inv_denominator + inv_denominator - denominator.mul(inv_denominator.square())
        )
    return numerator * inv_denominator


def log_softmax(self, dim=-1):
    """logits - max - log(sum exp(logits - max)) (approximations.py:752);
    over one element, the encrypted constant 0."""
    if self.dim() == 0 or self.size(dim) == 1:
        return public_constant(self, 0.0)
    logits = self - self.max_value(dim, keepdim=True)
    normalize_term = exp(logits).sum(axis=dim, keepdim=True)
    return logits - normalize_term.log()


for _name, _fn in (
    ("exp", exp), ("log", log), ("reciprocal", reciprocal), ("inv_sqrt", inv_sqrt),
    ("sqrt", sqrt), ("_eix", _eix), ("cossin", cossin), ("cos", cos),
    ("sin", sin), ("sigmoid", sigmoid), ("tanh", tanh), ("erf", erf), ("gelu", gelu),
    ("silu", silu), ("softmax", softmax), ("log_softmax", log_softmax),
):
    setattr(MPCTensor, _name, _fn)
