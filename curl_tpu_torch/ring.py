"""Ring arithmetic over Z_2^64 on torch.int64 tensors.

Counterpart of ``curl_tpu/ring.py``. Ring elements are ``torch.int64`` with
two's-complement wrap (the original Curl convention): add, sub, neg, mul and
left shifts wrap mod 2^64 natively. Right shifts on int64 are arithmetic in
torch, so every logical shift is masked by hand, and every Python constant is
folded into the signed int64 range with ``scalar``.

The one operation the card has no instruction for is the 64-bit integer
matmul (PyTorch implements no int64 matmul on CUDA). ``matmul`` and
``matmul_acc`` therefore dispatch CUDA tensors to the hand-written ring-mm
kernel (``kernels/ring_mm.py``), with no size gate and no fallback, and run
the plain version below on CPU tensors.

The plain version is the JAX package's balanced-limb path (``ring.py:193-221,
330-360``): each operand splits into eight signed int8 digits, the 36 limb
planes with i + j <= 7 are contracted exactly and recombined with shifts of
8(i + j) mod 2^64. The planes are contracted as float64 products, which are
exact here: every product is at most 2^14 in magnitude and every plane sum
below 2^31 (K < 2^17), far inside float64's 2^53.
"""

from __future__ import annotations

import contextlib
import math
import numbers
from collections import OrderedDict

import numpy as np
import torch

RING_BITS = 64
N_LIMBS = 8
LIMB_BITS = 8

# Maximum contraction size for exact int32 accumulation of balanced int8 limbs.
MAX_EXACT_K = 1 << 17

_MOD = 1 << 64


def scalar(value: int) -> int:
    """Python int folded into the signed int64 range (the value mod 2^64)."""
    v = int(value) % _MOD
    return v - _MOD if v >= (1 << 63) else v


def _ring_array(x) -> np.ndarray:
    """A host value as an int64 numpy array of ring elements."""
    arr = np.asarray(x)
    if arr.dtype == np.uint64:
        return arr.view(np.int64)
    if arr.dtype.kind in "iub":
        return arr.astype(np.int64)
    raise TypeError(f"cannot interpret dtype {arr.dtype} as ring element")


def to_ring(x, device=None) -> torch.Tensor:
    """Reinterpret anything integral as int64 ring elements (uint64 numpy
    arrays keep their bits). A Python int becomes a 0-d tensor filled on the
    device, with no copy from the host."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int64:
            return x if device is None else x.to(device)
        if x.dtype.is_floating_point:
            raise TypeError(f"cannot interpret dtype {x.dtype} as ring element")
        return x.to(device=device, dtype=torch.int64)
    if isinstance(x, numbers.Integral):
        return torch.full((), scalar(x), dtype=torch.int64, device=device)
    return torch.from_numpy(np.ascontiguousarray(_ring_array(x))).to(device)


# public host constants on their devices, most recently used last. The cap
# bounds only this shared cache, which serves eager forwards; a compiled
# runner reads its graph's constants from its own record
# (``holding_constants``), which nothing evicts.
_constants = OrderedDict()
MAX_CONSTANTS = 256
# the records of the runners capturing now, innermost last
_held = []


@contextlib.contextmanager
def holding_constants(held: dict):
    """Inside, every host constant looked up is read from ``held`` first
    and kept there: a compiled runner's record of the constants its warm-up
    made and its graph reads, alive for as long as the graph."""
    _held.append(held)
    try:
        yield
    finally:
        _held.pop()


def host_constant(arr, device) -> torch.Tensor:
    """A numpy array on ``device``, copied from the host once per (device,
    dtype, shape, contents) and kept (the shared cache keeps the last
    ``MAX_CONSTANTS``, a runner's record all it looked up): the public
    tables and constants of a forward are made at its first run, so that
    the same forward captured in a CUDA graph copies nothing from the host.
    Never written into."""
    arr = np.ascontiguousarray(arr)
    if torch.device(device).type == "meta":  # a lazy scope's shape evaluation
        return torch.empty(arr.shape, dtype=torch.from_numpy(np.zeros(1, arr.dtype)).dtype, device="meta")
    key = (str(torch.device(device)), arr.dtype.str, arr.shape, arr.tobytes())
    t = _held[-1].get(key) if _held else None
    if t is None:
        t = _constants.get(key)
    if t is None:
        t = torch.from_numpy(arr.copy()).to(device)
        _constants[key] = t
        if len(_constants) > MAX_CONSTANTS:
            _constants.popitem(last=False)
    elif key in _constants:
        _constants.move_to_end(key)
    if _held:
        _held[-1][key] = t
    return t


def constant(x, device) -> torch.Tensor:
    """``to_ring(x, device)`` of a public value; a host array (a LUT, an
    index list) through the cache of ``host_constant``."""
    if isinstance(x, (torch.Tensor, numbers.Integral)):
        return to_ring(x, device)
    return host_constant(_ring_array(x), device)


def to_numpy_u64(x: torch.Tensor) -> np.ndarray:
    """Ring tensor -> numpy uint64 with the same bits."""
    return x.detach().cpu().numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# Elementwise ring ops (exact mod 2^64)
# ---------------------------------------------------------------------------

def mul_pow2(a, bits: int):
    """Multiply by 2^bits (mod 2^64)."""
    return a if bits == 0 else a << bits


def shift_right_logical(a, bits: int):
    if bits == 0:
        return a
    if bits >= 64:
        return torch.zeros_like(a)
    return (a >> bits) & ((1 << (64 - bits)) - 1)


def shift_right_arith(a, bits: int):
    """Arithmetic shift of the signed view (the reference __rshift__)."""
    return a >> bits


def trunc_div_pow2_signed(a, bits: int):
    """Signed truncated division by 2^bits (torch div rounding_mode='trunc'):
    trunc(x / 2^m) = (x + (x < 0) * (2^m - 1)) >> m."""
    if bits == 0:
        return a
    corr = torch.where(a < 0, (1 << bits) - 1, 0)
    return (a + corr) >> bits


def trunc_div_signed(a, divisor: int):
    """Signed truncated division by a positive integer."""
    if divisor <= 0:
        raise ValueError("divisor must be positive")
    if divisor & (divisor - 1) == 0:
        return trunc_div_pow2_signed(a, divisor.bit_length() - 1)
    return torch.div(a, divisor, rounding_mode="trunc")


def floormod_pow2(a, bits: int):
    """a mod 2^bits as a nonnegative residue."""
    return a if bits >= 64 else a & ((1 << bits) - 1)


def signed_floordiv_pow2(a, bits: int):
    """Floor division of the signed view by 2^bits."""
    return a >> bits


def count_wraps(shares_stacked):
    """Overflow wraps when summing signed shares over the leading axis
    (reference util.py:15): two positives that overflow count +1, two
    negatives that underflow count -1."""
    result = torch.zeros_like(shares_stacked[0])
    prev = shares_stacked[0]
    for i in range(1, shares_stacked.shape[0]):
        cur = shares_stacked[i]
        nxt = prev + cur
        result = result + ((prev > 0) & (cur > 0) & (nxt < 0)).to(torch.int64)
        result = result - ((prev < 0) & (cur < 0) & (nxt > 0)).to(torch.int64)
        prev = nxt
    return result


# ---------------------------------------------------------------------------
# Limb decomposition: the plain matmul
# ---------------------------------------------------------------------------

def _balanced_limbs(x: torch.Tensor) -> torch.Tensor:
    """int64 -> 8 balanced int8 digits (limb axis appended last).

    x = sum_i d_i * 2^(8 i) (mod 2^64), d_i in [-128, 127]. Byte b plus the
    incoming carry c is recoded: if b + c >= 128 the digit is b + c - 256
    and a carry of 1 propagates. The 9th carry falls off mod 2^64."""
    digits = []
    carry = torch.zeros_like(x)
    for i in range(N_LIMBS):
        v = ((x >> (8 * i)) & 0xFF) + carry
        ge = v >= 128
        digits.append(torch.where(ge, v - 256, v).to(torch.int8))
        carry = ge.to(torch.int64)
    return torch.stack(digits, dim=-1)


def _combine_planes(planes: torch.Tensor) -> torch.Tensor:
    """Recombine (..., 8, 8) limb-plane sums (int64, each below 2^31 in
    magnitude) into ring elements mod 2^64."""
    out = torch.zeros(planes.shape[:-2], dtype=torch.int64, device=planes.device)
    for i in range(N_LIMBS):
        for j in range(N_LIMBS - i):
            out += planes[..., i, j] << (8 * (i + j))
    return out


def _plain_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (..., M, K) @ (..., K, N) mod 2^64 by the balanced-limb path.

    The ring-mm kernel's plain version: runs on any device (float64 plane
    products are exact, see the module docstring). Batch dims broadcast."""
    K = a.shape[-1]
    if a.is_meta or b.is_meta:  # a lazy scope's shape evaluation
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        return torch.empty(batch + (a.shape[-2], b.shape[-1]), dtype=torch.int64, device="meta")
    if K >= MAX_EXACT_K:
        # a K = 2^17 plane could reach exactly 2^31: split, as the JAX path
        half = K // 2
        return _plain_matmul(a[..., :half], b[..., :half, :]) + _plain_matmul(
            a[..., half:], b[..., half:, :]
        )
    da = _balanced_limbs(a).to(torch.float64)  # (..., M, K, 8)
    db = _balanced_limbs(b).to(torch.float64)  # (..., K, N, 8)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    out = torch.zeros(batch + (a.shape[-2], b.shape[-1]), dtype=torch.int64, device=a.device)
    for i in range(N_LIMBS):
        for j in range(N_LIMBS - i):
            plane = torch.matmul(da[..., i], db[..., j]).to(torch.int64)
            out += plane << (8 * (i + j))
    return out


def _kernel_operands(a, b):
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError("ring-mm operands must be at least 2-D")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"matmul inner dims mismatch {a.shape[-1]} vs {b.shape[-2]}")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int64 ring matmul: a (..., M, K) @ b (..., K, N) -> (..., M, N).

    Batch dims broadcast as in torch.matmul. 1-D operands follow the
    matmul conventions of the JAX package (``ring.py:245``)."""
    if a.ndim == 1 and b.ndim == 1:
        return matmul(a[None, :], b[:, None])[0, 0]
    squeeze_a = a.ndim == 1
    squeeze_b = b.ndim == 1
    if squeeze_a:
        a = a[None, :]
    if squeeze_b:
        b = b[:, None]
    _kernel_operands(a, b)
    if a.is_cuda or b.is_cuda:
        from .kernels import ring_mm

        out = ring_mm.ring_mm([(a, b)])
    else:
        out = _plain_matmul(a, b)
    if squeeze_a:
        out = out[..., 0, :]
    if squeeze_b:
        out = out[..., 0]
    return out


def matmul_acc(pairs) -> torch.Tensor:
    """sum_p (A_p @ B_p) mod 2^64 — the Beaver reconstruction sum.

    On CUDA all pairs accumulate in one kernel launch (one register
    accumulator, one output write); every operand must be at least 2-D."""
    pairs = list(pairs)
    if len(pairs) == 1:
        return matmul(*pairs[0])
    if any(a.is_cuda or b.is_cuda for a, b in pairs):
        from .kernels import ring_mm

        for a, b in pairs:
            _kernel_operands(a, b)
        return ring_mm.ring_mm(pairs)
    out = matmul(*pairs[0])
    for a, b in pairs[1:]:
        out = out + matmul(a, b)
    return out


# ---------------------------------------------------------------------------
# Convolutions: im2col columns through the ring matmul
# ---------------------------------------------------------------------------
#
# The JAX package convolves int8 limb planes with lax.conv_general_dilated
# (``ring.py:368-489``). Here a convolution is a product: the weight
# (O, C/g, *k) becomes g matrices (O/g, C/g * prod(k)) and the input's
# windows a column matrix (C/g * prod(k), prod(out)) per group, so that
# ``matmul`` (the ring-mm kernel on CUDA) computes every output channel at
# every position, already in NC(H)W order. The columns are built from
# ``Tensor.unfold`` views of the padded input and copied once, contiguous;
# a 1 x 1 convolution at stride 1 without padding reads the input in place.
# No randomness enters, so the result equals the JAX package's mod 2^64.
# Leading dims beyond (N, C, *spatial) of the input and (O, C/g, *k) of the
# weight are batch dims and broadcast, as a party axis does.

def _tuple(v, n: int):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * n


def _columns(x, k, stride, padding, dilation, groups):
    """x (..., C, *s) -> (columns (..., g, C/g * prod(k), prod(out)), out)."""
    nd = len(k)
    C = x.shape[-nd - 1]
    if any(padding):
        pads = []
        for p in reversed(padding):
            pads += [p, p]
        x = torch.nn.functional.pad(x, pads)
    if all(kk == 1 for kk in k):
        x = x[(Ellipsis,) + tuple(slice(None, None, s) for s in stride)]
        out = tuple(x.shape[-nd:])
        return x.reshape(x.shape[:-nd - 1] + (groups, C // groups, math.prod(out))), out
    win, base = x, x.dim() - nd
    for i in range(nd):  # a window axis per spatial dim, appended last
        win = win.unfold(base + i, dilation[i] * (k[i] - 1) + 1, stride[i])
    if any(d > 1 for d in dilation):
        win = win[(Ellipsis,) + tuple(slice(None, None, d) for d in dilation)]
    out = tuple(win.shape[-2 * nd:-nd])
    batch = win.shape[:-2 * nd - 1]
    # (..., C, *out, *k) -> (..., C, *k, *out)
    lead = len(batch) + 1
    perm = tuple(range(lead)) + tuple(lead + nd + i for i in range(nd)) + tuple(
        lead + i for i in range(nd))
    cols = win.permute(perm).reshape(batch + (groups, C // groups * math.prod(k), math.prod(out)))
    return cols, out


def _conv_pair(x, w, nd, stride=1, padding=0, dilation=1, groups=1):
    """(weight matrices, columns, output shape) of one ``convNd(x, w)``."""
    k = tuple(w.shape[-nd:])
    stride, padding, dilation = (_tuple(v, nd) for v in (stride, padding, dilation))
    cols, out = _columns(x, k, stride, padding, dilation, groups)
    O = w.shape[-nd - 2]
    mats = w.reshape(w.shape[:-nd - 2] + (groups, O // groups, -1))
    batch = torch.broadcast_shapes(cols.shape[:-3], mats.shape[:-3])
    return mats, cols, tuple(batch) + (O,) + out


def _transpose_input(x, w, nd, stride=1, padding=0, output_padding=0, dilation=1, groups=1):
    """conv_transpose as a convolution (``ring.py:417-440``): x dilated by
    the stride, padded by d (k - 1) - p (plus the output padding at the
    end; a negative pad crops), against the weight's spatially flipped
    (O, I) transpose at stride 1."""
    if groups != 1:
        raise NotImplementedError("grouped conv_transpose not implemented")
    stride, padding, output_padding, dilation = (
        _tuple(v, nd) for v in (stride, padding, output_padding, dilation))
    k = tuple(w.shape[-nd:])
    if any(s > 1 for s in stride):
        size = tuple((n - 1) * s + 1 for n, s in zip(x.shape[-nd:], stride))
        spread = x.new_zeros(x.shape[:-nd] + size)
        spread[(Ellipsis,) + tuple(slice(None, None, s) for s in stride)] = x
        x = spread
    pads = []
    for i in reversed(range(nd)):
        lo = dilation[i] * (k[i] - 1) - padding[i]
        pads += [lo, lo + output_padding[i]]
    x = torch.nn.functional.pad(x, pads)
    wf = w.flip(tuple(range(-nd, 0))).transpose(-nd - 2, -nd - 1)
    return x, wf, dict(dilation=dilation)


def _conv_pairs(op, pairs, kwargs):
    nd = 2 if op.endswith("2d") else 1
    out = []
    for x, w in pairs:
        kw = dict(kwargs)
        if op.startswith("conv_transpose"):
            x, w, kw = _transpose_input(x, w, nd, **kw)
        out.append(_conv_pair(x, w, nd, **kw))
    return out


def conv_acc(op, pairs, **kwargs) -> torch.Tensor:
    """sum_p op(x_p, w_p) mod 2^64 for ``op`` one of conv1d, conv2d,
    conv_transpose1d and conv_transpose2d under the same keyword arguments:
    one ``matmul_acc`` of the pairs' weight matrices and columns (one
    ring-mm launch on CUDA, each pair's columns read in place)."""
    made = _conv_pairs(op, pairs, kwargs)
    shape = torch.broadcast_shapes(*[s for _, _, s in made])
    prod = matmul_acc([(w, c) for w, c, _ in made])
    return prod.reshape(shape)


def conv2d(x, w, stride=1, padding=0, dilation=1, groups=1):
    """Ring conv2d, NCHW x OIHW, with torch.conv2d's semantics."""
    return conv_acc("conv2d", [(x, w)], stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def conv1d(x, w, stride=1, padding=0, dilation=1, groups=1):
    """Ring conv1d, NCL x OIL."""
    return conv_acc("conv1d", [(x, w)], stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def conv_transpose2d(x, w, stride=1, padding=0, output_padding=0, dilation=1, groups=1):
    """Ring conv_transpose2d with torch's semantics (IOHW weights)."""
    return conv_acc("conv_transpose2d", [(x, w)], stride=stride, padding=padding,
                    output_padding=output_padding, dilation=dilation, groups=groups)


def conv_transpose1d(x, w, stride=1, padding=0, output_padding=0, dilation=1, groups=1):
    """Ring conv_transpose1d (IOL weights)."""
    return conv_acc("conv_transpose1d", [(x, w)], stride=stride, padding=padding,
                    output_padding=output_padding, dilation=dilation, groups=groups)
