"""Fused 2-party comparison (``ltz``) and max-tournament step.

Counterpart of ``curl_tpu/ops/pallas_max_step.py``: the packed 32-bit sign
circuit (one Beaver AND level and five prefix levels of the SPK adder), the
B2A of the sign bit and, for a tournament step, the Beaver select
``rolled + ge * (carry - rolled)``, all in one pass that writes only the
result shares.

  ``*_math``   the protocol on torch int64 words (the JAX package runs it on
               u32 lo/hi planes), with an injectable ``rbits()`` (one 64-bit
               draw per word) and ``rbit()`` (one 0/1 draw per element as a
               (2, m) half-plane pair) called in the JAX math's order, so the
               tests hold it bit for bit against ``ltz_bit_math`` and
               ``max_step_math`` on the same draws;
  ``launch_ltz``, ``launch_max_step``  the CUDA kernel ``csrc/max_step.cu``
               (CUDA tensors only); ``plain_ltz`` / ``plain_max_step`` the
               same functions in torch on Philox draws;
  ``launch_fold_chain``, ``launch_butterfly_chain``  a scan_reduction stage
               in one launch: the G - 1 steps of a chunk fold, or the
               butterfly's steps with their rolls; ``plain_fold_chain`` /
               ``plain_butterfly_chain`` the per-step composition of
               ``plain_max_step`` they replace;
  ``ltz``, ``max_step``, ``fold_chain``, ``butterfly_chain``  the kernel on
               a CUDA tensor, the plain version on a CPU tensor;
  ``fused_ltz_mpc``, ``fused_max_step_mpc``, ``fused_fold_chain_mpc``,
               ``fused_butterfly_chain_mpc``  the MPC entry points behind
               ``mpc.fused_compare`` and ``mpc.fused_max_step`` = "cuda".

Packing: of n elements, element k (low 32-bit lane) and element k + m (high
lane) share word k, m = ceil(n / 2); an odd n pads one zero share, whose
result is dropped (ltz(0) = 0; the step's pad selects 0).

Randomness: draw number ``s`` of a call (its slot in the math's call order)
for word ``k`` is element ``k`` of ``philox.stream(key, count | s << 48)``;
an ``rbit()`` slot gives bit h of that element to half h. ``key`` is the
session's ``fused`` stream, named by its slot of the session key table
(``keys.KeyRef``: the kernel reads it on the device, the plain versions
from the host mirror), ``count``
a fresh draw count per call: the kernel and its plain version agree bit
for bit whatever the launch geometry, and two calls of one forward never
share a draw. A chain of steps takes consecutive draw counts
(``random.reserve_counts``), step i the count its own call would have
taken, so a chain's shares equal the per-step composition's bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ring import scalar
from . import build, keys
from .philox import MAX_COUNT, slot_counter, stream

MIN_ELEMENTS = 1024
MAX_DIMS = 6
# the widest row the butterfly kernel holds in shared memory (csrc/max_step.cu)
MAX_BUTTERFLY_WIDTH = 1024
LEVELS = 5  # prefix levels of the packed 32-bit adder
# draw slots of one call: A2B 2, AND levels 1 + 2 * LEVELS of 5 each, B2A 4;
# the step's select 10 more
DRAWS = {"ltz": 61, "max_step": 71}
_M32 = 0xFFFFFFFF
_MAX_N = (1 << 31) - 1

# launches of the kernel: by entry point ("ltz", "max_step", the chains
# "fold" and "butterfly"), and the step launches a butterfly chain makes
# where its rows do not pair ("butterfly_unpaired")
launches = {}


def _level_constants():
    """Per prefix level: the input mask, the multiplier 2^(2^i + 1) - 2 and
    the output mask (circuit.py's packed-32 SPK constants)."""
    masks, mults, out_masks = [], [], []
    for i in range(LEVELS):
        m = 0
        for start in range((1 << i) - 1, 64, 1 << (i + 1)):
            m |= 1 << start
        mult = (1 << ((1 << i) + 1)) - 2
        masks.append(scalar(m))
        mults.append(mult)
        out_masks.append(scalar(m * mult))
    return masks, mults, out_masks


MASKS, MULTS, OUT_MASKS = _level_constants()
BOUNDARY_CLEAR = scalar(((1 << 64) - 1) ^ (1 << 32))


# ---------------------------------------------------------------------------
# protocol math (torch int64 words; injectable randomness)
# ---------------------------------------------------------------------------

def _mul_const_pow2m2(x, k: int):
    """x * (2^k - 2) = (x << k) - (x << 1) mod 2^64."""
    return (x << k) - (x << 1)


def _beaver_and(u0, u1, v0, v1, rbits):
    """One Beaver AND on XOR shares: z0 ^ z1 = (u0 ^ u1) & (v0 ^ v1)."""
    a0, a1, b0, b1, c0 = rbits(), rbits(), rbits(), rbits(), rbits()
    c1 = ((a0 ^ a1) & (b0 ^ b1)) ^ c0
    eps = (u0 ^ a0) ^ (u1 ^ a1)
    delta = (v0 ^ b0) ^ (v1 ^ b1)
    # z = c ^ (eps & b) ^ (u & delta), u = a ^ eps
    return c0 ^ (b0 & eps) ^ (u0 & delta), c1 ^ (b1 & eps) ^ (u1 & delta)


def pack_words(d):
    """(2, m) half-planes -> (m,) words: the low 32 bits of half 0 in the
    low lane, of half 1 in the high lane (reducing a share mod 2^32 is
    dropping its high bits)."""
    return (d[0] & _M32) | (d[1] << 32)


def _sign_bits_math(d0, d1, rbits):
    """XOR shares (2, m) of the packed-32 sign bits of d = d0 + d1, from
    each party's (2, m) half-planes."""
    w0p, w1p = pack_words(d0), pack_words(d1)
    # A2B: XOR re-share each party's packed word
    x0 = rbits()
    x1 = x0 ^ w0p
    y1 = rbits()
    y0 = y1 ^ w1p
    # packed 32-bit adder: S = X & Y, P = X ^ Y, five prefix levels
    s0, s1 = _beaver_and(x0, x1, y0, y1, rbits)
    p_orig0, p_orig1 = x0 ^ y0, x1 ^ y1
    p0, p1 = p_orig0, p_orig1
    for i in range(LEVELS):
        k = (1 << i) + 1
        pm0, pm1 = p0 & OUT_MASKS[i], p1 & OUT_MASKS[i]
        sf0 = _mul_const_pow2m2(s0 & MASKS[i], k)
        sf1 = _mul_const_pow2m2(s1 & MASKS[i], k)
        pf0 = _mul_const_pow2m2(p0 & MASKS[i], k)
        pf1 = _mul_const_pow2m2(p1 & MASKS[i], k)
        us0, us1 = _beaver_and(pm0, pm1, sf0, sf1, rbits)
        up0, up1 = _beaver_and(pm0, pm1, pf0, pf1, rbits)
        s0, s1 = s0 ^ us0, s1 ^ us1
        not_out = ~OUT_MASKS[i]
        p0, p1 = (p0 & not_out) ^ up0, (p1 & not_out) ^ up1
    sum0 = p_orig0 ^ ((s0 << 1) & BOUNDARY_CLEAR)
    sum1 = p_orig1 ^ ((s1 << 1) & BOUNDARY_CLEAR)
    # sign bits: lane bit 31 -> half 0, lane bit 63 -> half 1
    lz0 = torch.stack([(sum0 >> 31) & 1, (sum0 >> 63) & 1])
    lz1 = torch.stack([(sum1 >> 31) & 1, (sum1 >> 63) & 1])
    return lz0, lz1


def _half_rbits(rbits):
    """Two word-shaped draws stacked into one (2, m) half-plane pair."""
    return torch.stack([rbits(), rbits()])


def _b2a_bit_math(bit0, bit1, rbits, rbit):
    """B2A of an XOR-shared bit, multiplication-free; (2, m) arithmetic
    shares per party."""
    rb = rbit()
    rb0 = rbit()
    rb1 = rb ^ rb0
    ra0 = _half_rbits(rbits)
    ra1 = rb - ra0
    t = bit0 ^ bit1 ^ rb0 ^ rb1  # public 0/1
    a0 = torch.where(t == 1, 1 - ra0, ra0)
    a1 = torch.where(t == 1, -ra1, ra1)
    return a0, a1


def ltz_bit_math(d0, d1, rbits, rbit):
    """Arithmetic 0/1 shares (2, m) of ltz(d) from each party's (2, m)
    half-planes of the additive shares of d."""
    lz0, lz1 = _sign_bits_math(d0, d1, rbits)
    return _b2a_bit_math(lz0, lz1, rbits, rbit)


def max_step_math(c0, c1, r0, r1, rbits, rbit):
    """New carry shares rolled + (carry >= rolled) * (carry - rolled), from
    each party's (2, m) half-planes of carry and rolled."""
    d0, d1 = c0 - r0, c1 - r1
    lz0, lz1 = _sign_bits_math(d0, d1, rbits)
    ga0, ga1 = _b2a_bit_math(lz0 ^ 1, lz1, rbits, rbit)  # ge = NOT ltz
    # Beaver select: rolled + ge * d
    a20, a21 = _half_rbits(rbits), _half_rbits(rbits)
    b20, b21 = _half_rbits(rbits), _half_rbits(rbits)
    c20 = _half_rbits(rbits)
    c21 = (a20 + a21) * (b20 + b21) - c20
    eps = (ga0 - a20) + (ga1 - a21)
    delta = (d0 - b20) + (d1 - b21)
    # prod = c + eps*b + ga*delta (ga = a + eps)
    return r0 + (c20 + eps * b20 + delta * ga0), r1 + (c21 + eps * b21 + delta * ga1)


# ---------------------------------------------------------------------------
# the kernel's functions: plain versions and CUDA wrappers
# ---------------------------------------------------------------------------

def _draws(key: keys.KeyRef, count: int, m: int, device):
    """rbits() and rbit() of one call, slot by slot."""
    key = key.value()
    slot = [0]

    def rbits():
        s = slot[0]
        slot[0] += 1
        return stream(key, slot_counter(count, s), m, device)

    def rbit():
        w = rbits()
        return torch.stack([w & 1, (w >> 1) & 1])

    return rbits, rbit


def _halves(share: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """(2, ...) shares -> (2, 2, m): [party, half, word], zero-padded."""
    flat = share.reshape(2, n)
    if 2 * m > n:
        flat = torch.cat([flat, flat.new_zeros(2, 2 * m - n)], dim=1)
    return flat.reshape(2, 2, m)


def _check(count, *shares):
    if not 0 <= count < MAX_COUNT:
        raise ValueError("max_step: the draw count must fit 48 bits")
    for t in shares:
        if t.dtype != torch.int64 or t.dim() < 1 or t.shape[0] != 2:
            raise ValueError("max_step takes (2, ...) int64 share tensors of two parties")


def _check_chain(count, steps, x):
    """A chain of ``steps`` >= 1 steps at draw counts count .. count + steps - 1."""
    _check(count, x)
    if steps < 1 or x.dim() < 2 or not count + steps <= MAX_COUNT:
        raise ValueError("max_step: a chain takes at least one step over a (2, ..., w) share, "
                         "its draw counts within 48 bits")


def _unhalve(a0, a1, n: int, shape):
    return torch.stack([a0.reshape(-1)[:n], a1.reshape(-1)[:n]]).reshape((2,) + tuple(shape))


def plain_ltz(d, key: keys.KeyRef, count: int) -> torch.Tensor:
    """(2, ...) shares of d -> (2, ...) arithmetic 0/1 shares of d < 0."""
    _check(count, d)
    shape = tuple(d.shape[1:])
    n = math.prod(shape)
    m = (n + 1) // 2
    h = _halves(d, n, m)
    a0, a1 = ltz_bit_math(h[0], h[1], *_draws(key, count, m, d.device))
    return _unhalve(a0, a1, n, shape)


def _broadcast_rolled(carry, rolled):
    nd = carry.dim() - 1
    extra = nd - (rolled.dim() - 1)
    if extra > 0:
        rolled = rolled.reshape((2,) + (1,) * extra + tuple(rolled.shape[1:]))
    return rolled.expand(carry.shape)


def plain_max_step(carry, rolled, key: keys.KeyRef, count: int) -> torch.Tensor:
    """(2, ...) shares of carry and rolled -> new carry shares."""
    _check(count, carry, rolled)
    rolled = _broadcast_rolled(carry, rolled)
    shape = tuple(carry.shape[1:])
    n = math.prod(shape)
    m = (n + 1) // 2
    c, r = _halves(carry, n, m), _halves(rolled, n, m)
    n0, n1 = max_step_math(c[0], c[1], r[0], r[1], *_draws(key, count, m, carry.device))
    return _unhalve(n0, n1, n, shape)


def _fold_steps(chunked) -> int:
    """The steps of a fold over a (2, ..., G, W) share: G - 1."""
    return chunked.shape[-2] - 1 if chunked.dim() >= 3 else 0


def plain_fold_chain(chunked, key: keys.KeyRef, count: int) -> torch.Tensor:
    """(2, ..., G, W) shares -> the (2, ..., W) running max over the G
    chunks: G - 1 tournament steps, step g (from 1) at draw count
    ``count + g - 1``, each the plain step."""
    _check_chain(count, _fold_steps(chunked), chunked)
    d = chunked.dim()
    carry = chunked.select(d - 2, 0)
    for g in range(1, chunked.shape[-2]):
        carry = plain_max_step(carry, chunked.select(d - 2, g), key, count + g - 1)
    return carry


def butterfly_shift(width: int, step: int) -> int:
    """The butterfly's roll at ``step``: x against x rolled by -(width >> (step + 1))."""
    return -(width >> (step + 1))


def plain_butterfly_chain(x, steps: int, key: keys.KeyRef, count: int) -> torch.Tensor:
    """``steps`` butterfly steps over the last dim, step i at draw count
    ``count + i``: x <- step(x, x.roll(butterfly_shift(w, i))), each the
    plain step."""
    _check_chain(count, steps, x)
    for i in range(steps):
        x = plain_max_step(x, x.roll(butterfly_shift(x.shape[-1], i), dims=-1), key, count + i)
    return x


def butterfly_pairs(shape) -> bool:
    """Whether the butterfly kernel takes a (...) shape: an even number of
    rows, each of an even width up to MAX_BUTTERFLY_WIDTH, so that word k's
    two elements (k, k + m, m = n / 2) are rows rho and rho + R / 2 of one
    column, which a block holds together."""
    width = shape[-1] if shape else 1
    rows = math.prod(shape[:-1])
    return width % 2 == 0 and width <= MAX_BUTTERFLY_WIDTH and rows % 2 == 0


class _Operand(ctypes.Structure):
    _fields_ = [
        ("ptr", ctypes.c_void_p),
        ("party", ctypes.c_longlong),
        ("mem", ctypes.c_longlong * MAX_DIMS),
    ]


class _Args(ctypes.Structure):
    _fields_ = [
        ("a", _Operand),
        ("b", _Operand),
        ("size", ctypes.c_longlong * MAX_DIMS),
        ("nd", ctypes.c_int),
        ("steps", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("b_step", ctypes.c_longlong),
        ("count", ctypes.c_uint64),
        ("dense", ctypes.c_int),
        ("key", ctypes.c_void_p),
    ]


def _lib():
    lib = build.load("max_step")
    if not getattr(lib, "_curl_bound", False):
        for fn in (lib.ltz_launch, lib.max_step_launch, lib.butterfly_launch):
            fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._curl_bound = True
    return lib


def _launch(entry, tag, key, count, a, b=None, steps=1, b_step=0):
    """One launch of ``entry`` (ltz, max_step or butterfly) on share views
    ``a`` (and ``b``, broadcast to a's shape), counted under ``tag``."""
    shares = (a,) if b is None else (a, b)
    dev = a.device
    if any(t.device.type != "cuda" or t.device != dev for t in shares):
        raise ValueError(f"{entry}: the shares must lie on one CUDA device")
    if b is not None:
        shares = (a, _broadcast_rolled(a, b))
    shape = tuple(a.shape[1:])
    n = math.prod(shape)
    if len(shape) > MAX_DIMS or n > _MAX_N:
        raise ValueError(f"{entry}: shape {shape} exceeds {MAX_DIMS} dims or 2^31 elements")
    out = torch.empty(a.shape, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    args = _Args()
    for op_struct, t in zip((args.a, args.b), shares):
        op_struct.ptr = t.data_ptr()
        op_struct.party = t.stride(0)
        for d in range(len(shape)):
            op_struct.mem[d] = t.stride(d + 1)
    for d, s in enumerate(shape):
        args.size[d] = s
    args.nd, args.n, args.steps, args.b_step = len(shape), n, steps, b_step
    key.value()  # one slot
    args.key, args.count = key.pointer(dev), count
    args.dense = int(a[0].is_contiguous())
    with torch.cuda.device(dev):
        rc = getattr(_lib(), f"{entry}_launch")(
            ctypes.byref(args), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, entry)
    launches[tag] = launches.get(tag, 0) + 1
    return out


def launch_ltz(d, key: keys.KeyRef, count: int) -> torch.Tensor:
    """Arithmetic 0/1 shares of d < 0 by the CUDA kernel, a thread per word
    pair (d read in place whatever its strides)."""
    _check(count, d)
    return _launch("ltz", "ltz", key, count, d)


def launch_max_step(carry, rolled, key: keys.KeyRef, count: int,
                    tag: str = "max_step") -> torch.Tensor:
    """New carry shares of one tournament step by the CUDA kernel (rolled
    broadcast to carry's shape by stride 0)."""
    _check(count, carry, rolled)
    return _launch("max_step", tag, key, count, carry, rolled)


def launch_fold_chain(chunked, key: keys.KeyRef, count: int) -> torch.Tensor:
    """``plain_fold_chain`` by one launch: the chunks read in place through
    their strides, the carry kept in registers."""
    steps = _fold_steps(chunked)
    _check_chain(count, steps, chunked)
    d = chunked.dim()
    return _launch("max_step", "fold", key, count, chunked.select(d - 2, 0),
                   chunked.select(d - 2, 1), steps=steps, b_step=chunked.stride(d - 2))


def launch_butterfly_chain(x, steps: int, key: keys.KeyRef, count: int) -> torch.Tensor:
    """``plain_butterfly_chain`` by the CUDA kernel: one launch where the
    rows pair (``butterfly_pairs``), else the step kernel once a step on a
    rolled copy (counted as "butterfly_unpaired")."""
    _check_chain(count, steps, x)
    if butterfly_pairs(tuple(x.shape[1:])):
        return _launch("butterfly", "butterfly", key, count, x, steps=steps)
    for i in range(steps):
        x = launch_max_step(x, x.roll(butterfly_shift(x.shape[-1], i), dims=-1), key, count + i,
                            tag="butterfly_unpaired")
    return x


def ltz(d, key: keys.KeyRef, count: int) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor (on the
    meta device, where a lazy scope evaluates shapes, the output's shape)."""
    if d.is_meta:
        return torch.empty(d.shape, dtype=torch.int64, device="meta")
    if d.device.type != "cuda":
        return plain_ltz(d, key, count)
    return launch_ltz(d, key, count)


def max_step(carry, rolled, key: keys.KeyRef, count: int) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if carry.is_meta:
        return torch.empty(carry.shape, dtype=torch.int64, device="meta")
    if carry.device.type != "cuda":
        return plain_max_step(carry, rolled, key, count)
    return launch_max_step(carry, rolled, key, count)


def fold_chain(chunked, key: keys.KeyRef, count: int) -> torch.Tensor:
    """The fold kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if chunked.is_meta:
        return torch.empty(chunked.select(chunked.dim() - 2, 0).shape, dtype=torch.int64,
                           device="meta")
    if chunked.device.type != "cuda":
        return plain_fold_chain(chunked, key, count)
    return launch_fold_chain(chunked, key, count)


def butterfly_chain(x, steps: int, key: keys.KeyRef, count: int) -> torch.Tensor:
    """The butterfly kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.is_meta:
        return torch.empty(x.shape, dtype=torch.int64, device="meta")
    if x.device.type != "cuda":
        return plain_butterfly_chain(x, steps, key, count)
    return launch_butterfly_chain(x, steps, key, count)


def reset_launches():
    launches.clear()


# ---------------------------------------------------------------------------
# MPC entry points
# ---------------------------------------------------------------------------

def _register_sign_circuit(n: int):
    """The packed-32 composable comparison's rounds and bytes: the S AND,
    the five prefix levels (two ANDs each) and the B2A open."""
    from .. import comm

    nw = (n + 1) // 2
    comm.register_virtual("all_xor", 2 * nw * 8, rounds=1)
    comm.register_virtual("all_xor", 5 * 4 * nw * 8, rounds=5)
    comm.register_virtual("all_xor", n * 8, rounds=1)


def fused_ltz_mpc(x):
    """Arithmetic 0/1 shares of x < 0 (an MPCTensor at scale 1) in one pass."""
    from .. import random as rng
    from ..encoder import FixedPointEncoder

    out = ltz(x.share, rng.fused_key(), rng._next_count())
    _register_sign_circuit(x.nelement())
    return _mpc(out, FixedPointEncoder(0))


def _register_step(n: int):
    """One tournament step's rounds and bytes: the comparison's plus the
    select's one open."""
    from .. import comm

    _register_sign_circuit(n)
    comm.register_virtual("all_sum", 2 * n * 8, rounds=1)


def _mpc(out, encoder):
    from ..mpc.mpc import MPCTensor
    from ..mpc.primitives.arithmetic import ArithmeticSharedTensor

    return MPCTensor(ArithmeticSharedTensor(out, encoder))


def fused_max_step_mpc(carry, rolled):
    """new = rolled + (carry >= rolled) * (carry - rolled) in one pass."""
    from .. import random as rng

    out = max_step(carry.share, rolled.share, rng.fused_key(), rng._next_count())
    _register_step(carry.nelement())
    return _mpc(out, carry.encoder)


def fused_fold_chain_mpc(chunked):
    """The running max of a (..., G, W) MPCTensor over its G chunks, (...,
    W): the G - 1 steps of ``fused_max_step_mpc`` in one pass, with the
    draw counts and the rounds and bytes of those steps."""
    from .. import random as rng

    steps = chunked.size(chunked.dim() - 2) - 1
    counts = rng.reserve_counts(steps)
    out = fold_chain(chunked.share, rng.fused_key(), counts[0])
    for _ in range(steps):
        _register_step(out[0].numel())
    return _mpc(out, chunked.encoder)


def fused_butterfly_chain_mpc(x, steps: int):
    """``steps`` butterfly steps over the last dim, x <- step(x, x.roll(
    -(w >> (i + 1)))), in one pass: the draw counts and the rounds and
    bytes of those steps of ``fused_max_step_mpc``."""
    from .. import random as rng

    counts = rng.reserve_counts(steps)
    out = butterfly_chain(x.share, steps, rng.fused_key(), counts[0])
    for _ in range(steps):
        _register_step(x.nelement())
    return _mpc(out, x.encoder)
