"""Wavelet lookup tables (Curl's core technique), numpy-native.

The port's own copy of ``curl_tpu/functions/luts.py``: the same discrete
wavelet decomposition from the filter banks

  haar     dec_lo = [1, 1] / sqrt(2)
  bior2.2  dec_lo = sqrt(2) * [0, -1/8, 1/4, 3/4, 1/4, -1/8]

with pywt's 'symmetric' boundary extension, and the same table generators,
so every table is bit-equal to the JAX package's. ``init`` builds every
table the config's methods use (``LookupTables().build_all()``), as the JAX
package's does; a table is also built on first use
(``LookupTables().LUTs[name]``). Each is kept in memory by its name and
the config values it was built from, so a config that comes back reuses
it; nothing is written to disk.
"""

from __future__ import annotations

import math

import numpy as np

from ..config import cfg

SQRT2 = math.sqrt(2.0)
_FILTERS = {
    "haar": np.array([1.0, 1.0]) / SQRT2,
    "bior2.2": np.array([0.0, -0.125, 0.25, 0.75, 0.25, -0.125]) * SQRT2,
}


def dwt_approx_level(x: np.ndarray, wavelet: str) -> np.ndarray:
    """One DWT analysis level: approx coefficients only."""
    h = _FILTERS[wavelet]
    L = len(h)
    xp = np.concatenate([x[: L - 1][::-1], x, x[::-1][: L - 1]])
    c = np.convolve(xp, h, mode="full")
    out_len = (len(x) + L - 1) // 2
    return c[L : L + 2 * out_len : 2]


def wavedec_approx(x: np.ndarray, wavelet: str, level: int) -> np.ndarray:
    """Approximation coefficients after ``level`` analysis passes."""
    if wavelet == "haar" and (len(x) & (len(x) - 1)) == 0:
        # haar approx at level d on a power-of-two length: block sums
        # scaled by 2^(-d/2)
        blocks = x.reshape(-1, 1 << level).sum(axis=1)
        return blocks * 2.0 ** (-level / 2)
    for _ in range(level):
        x = dwt_approx_level(x, wavelet)
    return x


def _generate_haar(max_bits, lut_bits, function, negative_values=False):
    scale = 2 ** cfg.encoder.precision_bits
    max_element = 2 ** max_bits
    depth = max_bits + cfg.encoder.precision_bits - lut_bits
    if negative_values:
        grid = np.linspace(-max_element + 1 / scale, max_element, 2 * max_element * scale)
    else:
        grid = np.linspace(1.0 / scale, max_element, max_element * scale)
    coeffs = wavedec_approx(function(grid), "haar", depth)
    return np.asarray(coeffs * 2.0 ** (-depth / 2) * scale).astype(np.int64)


def _generate_bior(max_bits, lut_bits, function, negative_values=False):
    scale = 2 ** cfg.encoder.precision_bits
    max_element = 2 ** max_bits
    depth = max_bits + cfg.encoder.precision_bits - lut_bits
    if negative_values:
        grid = np.linspace(-max_element + 1 / scale, max_element, 2 * max_element * scale)
        size = 2 ** (lut_bits + 1)
    else:
        grid = np.linspace(1.0 / scale, max_element, max_element * scale)
        size = 2 ** lut_bits
    coeffs = wavedec_approx(function(grid), "bior2.2", depth)
    banks = np.stack([np.roll(coeffs, -2)[:size], np.roll(coeffs, -3)[:size]])
    return np.asarray(banks * scale * 2.0 ** (depth * 0.5)).astype(np.int64)


def _sigmoid(x):
    return 1 / (1 + np.exp(-x))


def _relu(x):
    return x * (x > 0)


_erf_np = np.vectorize(math.erf)


def _gelu(x):
    return x * (1 + _erf_np(x / math.sqrt(2))) / 2


def _silu(x):
    return x * _sigmoid(x)


def _inv_sqrt(x):
    return np.reciprocal(np.sqrt(x))


def _exp_tables():
    """exp_haar / exp_bior / nexp_* (approximations.py:108-138)."""
    F = cfg.functions
    prec = cfg.encoder.precision_bits
    scale = 2 ** prec
    max_element = 2 ** F.exp_lut_max_bits
    out = {}
    depth = 1 + F.exp_lut_max_bits + prec - F.exp_haar_size_bits
    full = np.exp(
        np.linspace(-max_element, max_element - 1.0 / scale, 2 * max_element * scale)
    )
    coeffs = wavedec_approx(full, "haar", depth)
    out["exp_haar"] = (coeffs * 2.0 ** (-depth / 2) * scale).astype(np.int64)
    depth = 1 + F.exp_lut_max_bits + prec - F.exp_bior_size_bits
    coeffs = wavedec_approx(full, "bior2.2", depth)[: 2 ** F.exp_bior_size_bits]
    out["exp_bior"] = (np.stack([np.roll(coeffs, -2), np.roll(coeffs, -3)]) * scale).astype(
        np.int64
    )
    size = F.exp_neg_lut_size
    full = np.exp(-np.linspace(1.0 / size, 1 / 2 ** 4, size))
    out["nexp_low"] = (full * scale).astype(np.int64)
    full = np.exp(-np.linspace(1.0 * 2 ** 4 / size, 2 ** 4, size))
    out["nexp_high"] = (full * scale).astype(np.int64)
    out["nexp_haar"] = _generate_haar(
        F.exp_lut_max_bits, F.exp_haar_size_bits, lambda x: np.exp(-x)
    )
    out["nexp_bior"] = _generate_bior(
        F.exp_lut_max_bits, F.exp_bior_size_bits, lambda x: np.exp(-x)
    )
    return out


def _table_builders():
    """name -> (method config key, the size keys it reads, builder) for
    every table of the JAX package's initialize_luts
    (approximations.py:90-346). A builder reads
    its size keys when it runs, under a LUT method: a partial profile
    (configs/approximations.yaml) lacks the keys of the tables it never
    builds, as the JAX package builds only the configured methods'
    tables."""
    F = cfg.functions
    b = {}

    def pair(name, max_bits, haar_bits, bior_bits, fn, method_key, neg=False, suffix=""):
        """The haar and bior tables of ``name``; the sizes are config key
        names (``max_bits`` may be an int)."""
        def read(key):
            return key if isinstance(key, int) else getattr(F, key)

        b[f"{name}_haar{suffix}"] = (method_key, (max_bits, haar_bits), lambda: _generate_haar(
            read(max_bits), read(haar_bits), fn, neg))
        b[f"{name}_bior{suffix}"] = (method_key, (max_bits, bior_bits), lambda: _generate_bior(
            read(max_bits), read(bior_bits), fn, neg))

    exp_keys = ("exp_lut_max_bits", "exp_haar_size_bits", "exp_bior_size_bits", "exp_neg_lut_size")
    for name in ("exp_haar", "exp_bior", "nexp_low", "nexp_high", "nexp_haar", "nexp_bior"):
        b[name] = ("exp_method", exp_keys, lambda name=name: _exp_tables()[name])
    for name, fn in (("log", np.log), ("reciprocal", np.reciprocal), ("sqrt", np.sqrt),
                     ("inv_sqrt", _inv_sqrt)):
        pair(name, f"{name}_lut_max_bits", f"{name}_haar_size_bits", f"{name}_bior_size_bits",
             fn, f"{name}_method")
    if "inv_sqrt_tailored_0_lut_max_bits" in F:
        for i in (0, 1):
            b[f"inv_sqrt_tailored_haar_{i}"] = ("inv_sqrt_method", (
                f"inv_sqrt_tailored_{i}_lut_max_bits", f"inv_sqrt_tailored_{i}_haar_size_bits"),
                lambda i=i: _generate_haar(
                getattr(F, f"inv_sqrt_tailored_{i}_lut_max_bits"),
                getattr(F, f"inv_sqrt_tailored_{i}_haar_size_bits"), _inv_sqrt))
    trig = ("trigonometry_haar_size_bits", "trigonometry_bior_size_bits")
    for fname, fn in (("sin", np.sin), ("cos", np.cos)):
        periodic = (lambda g: (lambda x: g(x * np.pi * 2)))(fn)
        pair(fname, 0, *trig, periodic, "trigonometry_method")
        pair(fname, "trigonometry_lut_max_bits", *trig, periodic, "trigonometry_method", True,
             "_lut_only")
    st = ("sigmoid_tanh_haar_size_bits", "sigmoid_tanh_bior_size_bits")
    pair("sigmoid", "sigmoid_lut_max_bits", *st, _sigmoid, "sigmoid_tanh_method")
    pair("sigmoid", "sigmoid_lut_max_bits", *st, _sigmoid, "sigmoid_tanh_method", True,
         "_lut_only")
    pair("tanh", "tanh_lut_max_bits", *st, np.tanh, "sigmoid_tanh_method")
    # as in the JAX package, the lut-only tanh tables span the sigmoid domain
    pair("tanh", "sigmoid_lut_max_bits", *st, np.tanh, "sigmoid_tanh_method", True, "_lut_only")
    for name, fn, lut_only in (("erf", _erf_np, _erf_np),
                               ("gelu", lambda x: _relu(x) - _gelu(x), _gelu),
                               ("silu", lambda x: _relu(x) - _silu(x), _silu)):
        sizes = (f"{name}_lut_max_bits", f"{name}_haar_size_bits", f"{name}_bior_size_bits")
        pair(name, *sizes, fn, f"{name}_method")
        pair(name, *sizes, lut_only, f"{name}_method", True, "_lut_only")
    return b


_LUT_METHODS = ("haar", "bior", "haar-lut-only", "bior-lut-only")
_EXTRA_METHODS = {"exp_method": ("split",), "inv_sqrt_method": ("tailored_haar",)}


# every table built in this process, by (name, precision, its size values)
_BUILT = {}


class _LazyTables(dict):
    """dict of tables that builds a missing one on first access."""

    def __init__(self, builders):
        super().__init__()
        self._builders = builders

    def __missing__(self, name):
        method_key, sizes, build = self._builders[name]
        method = getattr(cfg.functions, method_key)
        if method not in _LUT_METHODS + _EXTRA_METHODS.get(method_key, ()):
            raise KeyError(f"table {name!r} is not built under {method_key}={method!r}")
        key = (name, cfg.encoder.precision_bits) + tuple(
            k if isinstance(k, int) else getattr(cfg.functions, k) for k in sizes)
        table = _BUILT.get(key)
        if table is None:
            table = _BUILT[key] = build()
        self[name] = table
        return table

    def names(self):
        """Every table the current config builds (the JAX package's set)."""
        return [
            n for n, (key, _, _) in self._builders.items()
            if getattr(cfg.functions, key) in _LUT_METHODS + _EXTRA_METHODS.get(key, ())
        ]


class LookupTables:
    """Singleton table store, rebuilt when the relevant config changes."""

    _instance = None

    def __new__(cls):
        key = cls._config_key()
        if cls._instance is not None and cls._instance._key == key:
            return cls._instance
        inst = object.__new__(cls)
        inst._key = key
        inst.LUTs = _LazyTables(_table_builders())
        cls._instance = inst
        return inst

    def build_all(self):
        """Build every table the current config's methods use (the JAX
        package's initialize_luts at init)."""
        for name in self.LUTs.names():
            self.LUTs[name]
        return self

    @staticmethod
    def _config_key():
        f = cfg.functions.to_dict()
        return (cfg.encoder.precision_bits,) + tuple(sorted((k, str(v)) for k, v in f.items()))
