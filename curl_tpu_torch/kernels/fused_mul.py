"""Fused 2-party elementwise Beaver multiply / square and EGK truncation.

Counterpart of ``curl_tpu/ops/pallas_mul.py``: one pass computes both
parties' result shares of an elementwise private product, its triple drawn
inside the pass, the eps/delta open and the reconstruction, then the
rescale by the EGK+20 probabilistic truncation (l = 62) or the 2-party
local crypten truncation; or the EGK truncation of existing shares alone.

  ``*_math``   the protocol on torch int64 values (the JAX package runs it on
               u32 lo/hi planes because Mosaic has no 64-bit integers), with an
               injectable randomness source ``r64()`` / ``rk(bits)`` called in
               the JAX math's order, so the tests hold it bit for bit against
               ``pallas_mul.fused_op_math`` on the same draws;
  ``launch``   the CUDA kernel ``csrc/fused_mul.cu`` (CUDA tensors only), and
               ``plain``, the same function in torch on Philox draws;
  ``launch_square_chain``  a chain of squarings in one launch (exp's), and
               ``plain_square_chain``, ``plain`` called once a step;
  ``fused_mul``, ``square_chain``  the kernel on a CUDA tensor, the plain
               version on a CPU tensor;
  ``fused_*_mpc``  the MPC entry points behind ``mpc.fused_mul`` /
               ``mpc.fused_trunc`` = "cuda".

Randomness: draw number ``s`` of a call (its slot in the math's call order)
at index ``i`` is element ``i`` of ``philox.stream(key, count | s << 48)``,
``key`` the session's ``fused`` stream (derived from the dealer seed),
named by its slot of the session key table (``keys.KeyRef``), which the
kernel reads on the device and the plain version from the host mirror, and
``count`` one fresh draw count per call, so kernel and plain version agree bit for bit whatever the launch
geometry and two calls never share a draw.
``rk(bits)`` keeps the LOW ``bits`` bits of a draw, as the TPU kernel does.
The index is the element's place in the index space of what is drawn:
Beaver's ``a`` (and its share mask) ranges over x's elements, ``b`` over
y's, everything else over the output's. A broadcast operand therefore gets
one mask per element of its own and is opened at its own size, exactly as
the composable protocol opens it. Step s of a chain takes draw count
``count + s`` (``random.reserve_counts``), the count its own call would
have taken, so a chain's shares equal the per-step calls' bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ring import scalar
from . import build, keys
from .philox import MAX_COUNT, slot_counter, stream

OPS = ("mul", "square", "trunc")
TRUNCS = ("none", "egk", "crypten")
EGK_L = 62
MIN_ELEMENTS = 1024
MAX_DIMS = 6
_MAX_N = (1 << 31) - 1

# launches of the kernel, by "op+trunc", a chain by "op+trunc+chain"
launches = {}


# ---------------------------------------------------------------------------
# protocol math (torch int64, wrapping mod 2^64; injectable randomness)
# ---------------------------------------------------------------------------

def low_bits(a, bits: int):
    """The low ``bits`` bits of a 64-bit draw (``rk`` of the TPU kernel)."""
    return a if bits >= 64 else a & ((1 << bits) - 1)


def shr(a, k: int):
    """Logical right shift (torch's ``>>`` on int64 is arithmetic)."""
    return a if k == 0 else (a >> k) & ((1 << (64 - k)) - 1)


def sar(a, k: int):
    """Arithmetic (sign-extending) right shift."""
    return a if k == 0 else a >> k


def trunc_div_pow2(a, m: int):
    """Signed truncated division by 2^m, per share: the 2PC-local crypten
    truncation (s + (s < 0) * (2^m - 1)) >> m."""
    if m == 0:
        return a
    return sar(a + torch.where(a < 0, (1 << m) - 1, 0), m)


def _share_pair(value, r64):
    """PRZS + party-0-adds-plaintext sharing of an in-pass draw."""
    s = r64()
    return s + value, -s


def beaver_mul_math(x0, x1, y0, y1, r64):
    """Both parties' shares of x*y: triple + the two-product reconstruction."""
    a = r64()
    b = r64()
    c = a * b
    a0, a1 = _share_pair(a, r64)
    b0, b1 = _share_pair(b, r64)
    c0, c1 = _share_pair(c, r64)
    eps = (x0 - a0) + (x1 - a1)
    delta = (y0 - b0) + (y1 - b1)
    return c0 + eps * b0 + x0 * delta, c1 + eps * b1 + x1 * delta


def beaver_square_math(x0, x1, r64):
    """Both parties' shares of x^2 (party 0 adds the public eps^2)."""
    r = r64()
    r2 = r * r
    r0, r1 = _share_pair(r, r64)
    r20, r21 = _share_pair(r2, r64)
    eps = (x0 - r0) + (x1 - r1)
    return r20 + (r0 << 1) * eps + eps * eps, r21 + (r1 << 1) * eps


def egk_trunc_math(z0, z1, m: int, r64, rk, l: int = EGK_L):
    """EGK+20 Fig. 10 probabilistic truncation by 2^m with one reveal."""
    k = 64
    r_sh = _share_pair(rk(l - m), r64)
    rp_sh = _share_pair(rk(m), r64)
    b_sh = _share_pair(rk(1), r64)
    # step 1: mask and reveal c
    a = (z0 + scalar(1 << (l - 1)), z1)
    enc = [(a[p] + ((b_sh[p] << l) + ((r_sh[p] << m) + rp_sh[p]))) << (k - l - 1)
           for p in (0, 1)]
    c_p = sar(enc[0] + enc[1], k - l - 1)
    # step 2: strip the masking bit (c_pl public 0/1)
    c_pl = shr(c_p, l) & 1
    v0 = torch.where(c_pl == 1, 1 - b_sh[0], b_sh[0])
    v1 = torch.where(c_pl == 1, -b_sh[1], b_sh[1])
    # step 3: reconstruct the truncation
    pub_tail = shr(c_p & ((1 << l) - 1), m)
    y0 = (v0 << (l - m)) - r_sh[0] + (scalar(-(1 << (l - m - 1))) + pub_tail)
    y1 = (v1 << (l - m)) - r_sh[1]
    return y0, y1


def fused_op_math(op, trunc, m, x0, x1, y0, y1, r64, rk):
    """op in {mul, square, trunc}; trunc in {none, egk, crypten}."""
    if op == "mul":
        z0, z1 = beaver_mul_math(x0, x1, y0, y1, r64)
    elif op == "square":
        z0, z1 = beaver_square_math(x0, x1, r64)
    else:  # truncation of existing shares
        z0, z1 = x0, x1
    if trunc == "egk":
        z0, z1 = egk_trunc_math(z0, z1, m, r64, rk)
    elif trunc == "crypten":
        z0, z1 = trunc_div_pow2(z0, m), trunc_div_pow2(z1, m)
    return z0, z1


def slot_spaces(op: str, trunc: str):
    """The index space of each draw, in call order: x, y or out."""
    spaces = {"mul": ["x", "y", "x", "y", "out"], "square": ["out"] * 3, "trunc": []}[op]
    return spaces + (["out"] * 6 if trunc == "egk" else [])


# ---------------------------------------------------------------------------
# the kernel's function: plain version and CUDA wrapper
# ---------------------------------------------------------------------------

def _lift(share: torch.Tensor, nd: int) -> torch.Tensor:
    extra = nd - (share.dim() - 1)
    return share.reshape((share.shape[0],) + (1,) * extra + tuple(share.shape[1:])) if extra > 0 \
        else share


def _check(op, trunc, m, x, y, count):
    if op not in OPS or trunc not in TRUNCS:
        raise ValueError(f"fused_mul: unknown op {op!r} or trunc {trunc!r}")
    if (op == "mul") != (y is not None):
        raise ValueError("fused_mul: 'mul' takes x and y, 'square' and 'trunc' x alone")
    if op == "trunc" and trunc != "egk":
        raise ValueError("fused_mul: 'trunc' is the EGK truncation alone")
    if not 0 <= m < (EGK_L if trunc == "egk" else 63):
        raise ValueError(f"fused_mul: truncation by {m} bits is out of range")
    if not 0 <= count < MAX_COUNT:
        raise ValueError("fused_mul: the draw count must fit 48 bits")
    for t in (x,) if y is None else (x, y):
        if t.dtype != torch.int64 or t.dim() < 1 or t.shape[0] != 2:
            raise ValueError("fused_mul takes (2, ...) int64 share tensors of two parties")
    shape = tuple(torch.broadcast_shapes(tuple(x.shape[1:]), tuple(y.shape[1:]))
                  if y is not None else x.shape[1:])
    return shape


def _check_steps(steps: int, count: int):
    if steps < 1 or count + steps > MAX_COUNT:
        raise ValueError("fused_mul: a chain takes at least one step, its draw counts within "
                         "48 bits")


def plain(op, trunc, m, x, y, key: keys.KeyRef, count: int) -> torch.Tensor:
    """The kernel's function in plain torch: (2, *shape) result shares."""
    shape = _check(op, trunc, m, x, y, count)
    key = key.value()
    nd = len(shape)
    xs = _lift(x, nd)
    ys = _lift(y, nd) if y is not None else None
    dims = {"x": tuple(xs.shape[1:]), "y": tuple(ys.shape[1:]) if ys is not None else None,
            "out": shape}
    spaces = slot_spaces(op, trunc)
    slot = [0]

    def r64():
        s = slot[0]
        slot[0] += 1
        space = dims[spaces[s]]
        return stream(key, slot_counter(count, s), math.prod(space), x.device).reshape(space)

    def rk(bits):
        return low_bits(r64(), bits)

    z0, z1 = fused_op_math(op, trunc, m, xs[0], xs[1], ys[0] if ys is not None else None,
                           ys[1] if ys is not None else None, r64, rk)
    return torch.stack([z0.expand(shape), z1.expand(shape)])


def plain_square_chain(trunc, m, x, steps: int, key: keys.KeyRef, count: int) -> torch.Tensor:
    """``steps`` squarings with their rescale, step s at draw count
    ``count + s``: ``plain`` called ``steps`` times."""
    _check_steps(steps, count)
    for s in range(steps):
        x = plain("square", trunc, m, x, None, key, count + s)
    return x


class _Operand(ctypes.Structure):
    _fields_ = [
        ("ptr", ctypes.c_void_p),
        ("party", ctypes.c_longlong),
        ("mem", ctypes.c_longlong * MAX_DIMS),
        ("logical", ctypes.c_longlong * MAX_DIMS),
        ("dense", ctypes.c_int),
    ]


class _Args(ctypes.Structure):
    _fields_ = [
        ("x", _Operand),
        ("y", _Operand),
        ("size", ctypes.c_longlong * MAX_DIMS),
        ("nd", ctypes.c_int),
        ("op", ctypes.c_int),
        ("trunc", ctypes.c_int),
        ("m", ctypes.c_int),
        ("steps", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("count", ctypes.c_uint64),
        ("key", ctypes.c_void_p),
    ]


def _lib():
    lib = build.load("fused_mul")
    if not getattr(lib, "_curl_bound", False):
        lib.fused_mul_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p, ctypes.c_void_p]
        lib.fused_mul_launch.restype = ctypes.c_int
        lib._curl_bound = True
    return lib


def operand_strides(share: torch.Tensor, shape):
    """(memory strides, index-space strides) of a (2, ...) share read at
    every element of the per-party broadcast ``shape``: 0 on a broadcast
    dim; the index-space strides are those of the operand's own contiguous
    shape, so a draw's index does not depend on its memory layout."""
    s = _lift(share, len(shape))
    own = tuple(s.shape[1:])
    mem, logical, acc = [], [], 1
    for d in reversed(range(len(shape))):
        bcast = own[d] == 1 and shape[d] != 1
        mem.append(0 if bcast else s.stride(d + 1))
        logical.append(0 if bcast else acc)
        acc *= own[d]
    return mem[::-1], logical[::-1]


def _is_dense(share: torch.Tensor, shape) -> bool:
    """Whether the kernel reads ``share`` at output element i as ``ptr[i]``
    (and party 1's at ``ptr[party + i]``) with draw index i, each party's
    share of an element pair one 16-byte load: no broadcast dim, contiguous
    over the output, a 16-byte aligned start and an even party stride."""
    mem, logical = operand_strides(share, shape)
    return (all(m == lg or n == 1 for m, lg, n in zip(mem, logical, shape))
            and math.prod(shape) == math.prod(share.shape[1:])
            and share.data_ptr() % 16 == 0 and share.stride(0) % 2 == 0)


def _fill(op_struct, share, shape):
    mem, logical = operand_strides(share, shape)
    op_struct.ptr = share.data_ptr()
    op_struct.party = share.stride(0)
    op_struct.dense = int(_is_dense(share, shape))
    for d in range(len(shape)):
        op_struct.mem[d] = mem[d]
        op_struct.logical[d] = logical[d]


def launch(op, trunc, m, x, y, key: keys.KeyRef, count: int, steps: int = 1) -> torch.Tensor:
    """(2, *shape) result shares by the CUDA kernel. ``x``/``y``: (2, ...)
    int64 shares on one CUDA device, read in place whatever their strides;
    ``y`` is None for square and trunc. ``steps`` > 1: a chain of
    squarings (``plain_square_chain``), counted as "square+<trunc>+chain"."""
    shape = _check(op, trunc, m, x, y, count)
    _check_steps(steps, count)
    if steps > 1 and op != "square":
        raise ValueError("fused_mul: only a square takes a chain of steps")
    if any(t.device.type != "cuda" or t.device != x.device for t in (x, y) if t is not None):
        raise ValueError("fused_mul: the shares must lie on one CUDA device")
    n = math.prod(shape)
    if len(shape) > MAX_DIMS or n > _MAX_N:
        raise ValueError(f"fused_mul: shape {shape} exceeds {MAX_DIMS} dims or 2^31 elements")
    out = torch.empty((2,) + shape, dtype=torch.int64, device=x.device)
    if n == 0:
        return out
    args = _Args()
    _fill(args.x, x, shape)
    if y is not None:
        _fill(args.y, y, shape)
    for d, s in enumerate(shape):
        args.size[d] = s
    args.nd, args.n = len(shape), n
    args.op, args.trunc, args.m, args.steps = OPS.index(op), TRUNCS.index(trunc), m, steps
    key.value()  # one slot
    args.key, args.count = key.pointer(x.device), count
    with torch.cuda.device(x.device):
        rc = _lib().fused_mul_launch(ctypes.byref(args), out.data_ptr(),
                                     torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "fused_mul")
    tag = f"{op}+{trunc}" + ("+chain" if steps > 1 else "")
    launches[tag] = launches.get(tag, 0) + 1
    return out


def launch_square_chain(trunc, m, x, steps: int, key: keys.KeyRef, count: int) -> torch.Tensor:
    """``plain_square_chain`` by one launch: x read once, each element's
    ``steps`` squarings in registers, only the last result written."""
    return launch("square", trunc, m, x, None, key, count, steps)


def fused_mul(op, trunc, m, x, y, key: keys.KeyRef, count: int) -> torch.Tensor:
    """(2, *shape) result shares: the kernel on a CUDA tensor, the plain
    version on a CPU tensor (on the meta device, where a lazy scope
    evaluates shapes, the output's shape)."""
    if x.is_meta:
        shape = _check(op, trunc, m, x, y, count)
        return torch.empty((2,) + tuple(shape), dtype=torch.int64, device="meta")
    if x.device.type != "cuda":
        return plain(op, trunc, m, x, y, key, count)
    return launch(op, trunc, m, x, y, key, count)


def square_chain(trunc, m, x, steps: int, key: keys.KeyRef, count: int) -> torch.Tensor:
    """The chain: one launch on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.is_meta:
        return torch.empty(x.shape, dtype=torch.int64, device="meta")
    if x.device.type != "cuda":
        return plain_square_chain(trunc, m, x, steps, key, count)
    return launch_square_chain(trunc, m, x, steps, key, count)


def reset_launches():
    launches.clear()


# ---------------------------------------------------------------------------
# MPC entry points
# ---------------------------------------------------------------------------

def fused_available(x, y=None, key: str = "fused_mul") -> bool:
    """2 parties, the TFP dealer, the Beaver protocol, passive security and
    at least MIN_ELEMENTS elements after broadcasting; ``key`` selects the
    knob (mpc.fused_mul for mul/square, mpc.fused_trunc for trunc). Not
    gated on the tuple cache (pallas_mul.py:319-327): the pass draws in the
    kernel from the ``fused`` key and asks the provider for nothing, so it
    engages alike in the run that records the requests and the run served
    them."""
    from .. import comm
    from ..config import cfg
    from ..mpc import get_default_provider

    if getattr(cfg.mpc, key, None) != "cuda":
        return False
    if cfg.mpc.active_security or cfg.mpc.protocol != "beaver":
        return False
    shape = torch.broadcast_shapes(tuple(x.shape), tuple(y.shape) if y is not None else ())
    if math.prod(shape) < MIN_ELEMENTS:
        return False
    return get_default_provider().NAME == "TFP" and comm.get_world_size() == 2


def _run(op, x, y, trunc, m):
    from .. import comm
    from .. import random as rng
    from ..mpc.primitives.arithmetic import ArithmeticSharedTensor

    out = fused_mul(op, trunc, m, x.share, y.share if y is not None else None, rng.fused_key(),
                    rng._next_count())
    n = math.prod(out.shape[1:])
    if op == "mul":
        # eps and delta, each opened at its operand's own size
        nx, ny = math.prod(x.shape), math.prod(y.shape)
        comm.register_virtual("all_sum", (nx + ny) * 8, rounds=1)
    elif op == "square":
        comm.register_virtual("all_sum", n * 8, rounds=1)  # eps
    if trunc == "egk":
        comm.register_virtual("all_sum", n * 8, rounds=1)  # EGK c
    return ArithmeticSharedTensor(out, x.encoder)


def fused_mul_mpc(x, y, trunc: str, m: int):
    """Elementwise private x*y with its rescale (trunc: egk | crypten | none)."""
    return _run("mul", x, y, trunc, m)


def fused_square_mpc(x, trunc: str, m: int):
    """Private x^2 with its rescale."""
    return _run("square", x, None, trunc, m)


def square_bits(x) -> int:
    """The bits a private square rescales by: the precision of a
    fixed-point x, none for an integer."""
    return x.encoder.precision_bits if x.encoder.scale > 1 else 0


def fused_square_chain_mpc(x, steps: int, m: int):
    """``steps`` private squarings, each with the crypten rescale by 2^m, in
    one pass: the draw counts, rounds and bytes of ``steps`` calls of
    ``fused_square_mpc(x, "crypten", m)``."""
    from .. import comm
    from .. import random as rng
    from ..mpc.primitives.arithmetic import ArithmeticSharedTensor

    counts = rng.reserve_counts(steps)
    out = square_chain("crypten", m, x.share, steps, rng.fused_key(), counts[0])
    for _ in range(steps):
        comm.register_virtual("all_sum", math.prod(x.shape) * 8, rounds=1)  # eps
    return ArithmeticSharedTensor(out, x.encoder)


def fused_trunc_mpc(x, m: int):
    """EGK+20 probabilistic truncation by 2^m (l = 62) of existing shares."""
    return _run("trunc", x, None, "egk", m)
