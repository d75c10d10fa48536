"""Wrapper of the CUDA Philox kernel (``csrc/philox.cu``) and its plain version.

``philox(mode, keys, counter, n, ...)`` returns a ``(rows, n)`` int64 tensor:

  draw        row s: the 64-bit stream of ``keys[s]``, logically shifted
              right by ``64 - kbits``;
  przs        row p: stream(keys[p - 1]) - stream(keys[p]) (keys are the
              ring seeds; rows telescope to zero over the parties);
  share       przs + [p == src] * plain, plain (n,) shared by the parties;
  share_lane  przs + [p == src] * plain[src], plain (P, n) per party.

Stream element 2j and 2j + 1 are the four words of Philox4x32-10 at counter
(j_lo, j_hi, draw_lo, draw_hi) under key (seed_lo, seed_hi). On a CUDA
device the kernel runs; on the CPU the plain version, which is the same
Philox in torch int64 arithmetic (32-bit products via masking) and is
bit-identical to the kernel on every device.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MODES = {"draw": 0, "przs": 1, "share": 2, "share_lane": 3}
MAX_ROWS = 8

_M32 = 0xFFFFFFFF
_MUL0, _MUL1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

# The fused protocol kernels (fused_mul.cu, max_step.cu) key their draws by
# a Philox counter of the call's draw count and the draw's slot
SLOT_SHIFT = 48
MAX_COUNT = 1 << SLOT_SHIFT

# launches of the kernel, by mode
launches = {}


def _lib():
    lib = build.load("philox")
    if not getattr(lib, "_curl_bound", False):
        lib.philox_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.philox_launch.restype = ctypes.c_int
        lib._curl_bound = True
    return lib


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 words (PyTorch's
    PhiloxRNGEngine: round, then bump the key, ten rounds)."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _M32
            k1 = (k1 + _W1) & _M32
        p0 = c0 * _MUL0  # < 2^64: the int64 wrap keeps all 64 bits
        p1 = c2 * _MUL1
        c0, c1, c2, c3 = (
            ((p1 >> 32) & _M32) ^ c1 ^ k0,
            p1 & _M32,
            ((p0 >> 32) & _M32) ^ c3 ^ k1,
            p0 & _M32,
        )
    return c0, c1, c2, c3


def stream(key: int, counter: int, n: int, device) -> torch.Tensor:
    """Plain version of one stream: n int64 elements of (key, counter)."""
    j = torch.arange((n + 1) // 2, dtype=torch.int64, device=device)
    c2 = torch.full_like(j, counter & _M32)
    c3 = torch.full_like(j, (counter >> 32) & _M32)
    r0, r1, r2, r3 = philox4x32_10(j & _M32, j >> 32, c2, c3, key & _M32, (key >> 32) & _M32)
    e0 = r0 | (r1 << 32)
    e1 = r2 | (r3 << 32)
    return torch.stack([e0, e1], dim=-1).reshape(-1)[:n]


def slot_counter(count: int, slot: int) -> int:
    """The 64-bit Philox counter of draw ``slot`` of a fused call with draw
    count ``count`` (``csrc/philox.cuh``'s ``philox_slot``)."""
    return count | (slot << SLOT_SHIFT)


def _check(mode, keys, n, plain, src, kbits):
    if mode not in MODES:
        raise ValueError(f"unknown philox mode {mode!r}")
    if not 1 <= len(keys) <= MAX_ROWS:
        raise ValueError(f"philox takes 1 to {MAX_ROWS} keys, got {len(keys)}")
    if not 1 <= kbits <= 64:
        raise ValueError(f"kbits {kbits} outside 1..64")
    if mode in ("share", "share_lane"):
        want = (n,) if mode == "share" else (len(keys), n)
        if plain is None or plain.dtype != torch.int64 or tuple(plain.shape) != want:
            raise ValueError(f"philox {mode} takes an int64 plain of shape {want}")
        if not plain.is_contiguous():
            raise ValueError("philox plain must be contiguous")
        if not 0 <= src < len(keys):
            raise ValueError(f"src {src} outside the {len(keys)} parties")


def plain_philox(mode, keys, counter, n, plain=None, src=0, kbits=64, device=None):
    """The kernel's function in plain torch (any device)."""
    _check(mode, keys, n, plain, src, kbits)
    device = plain.device if plain is not None else device
    rows = [stream(k, counter, n, device) for k in keys]
    if mode == "draw":
        if kbits < 64:
            rows = [(r >> (64 - kbits)) & ((1 << kbits) - 1) for r in rows]
        return torch.stack(rows)
    P = len(rows)
    out = torch.stack([rows[(p - 1) % P] - rows[p] for p in range(P)])
    if mode == "share":
        out[src] += plain
    elif mode == "share_lane":
        out[src] += plain[src]
    return out


def philox(mode, keys, counter, n, plain=None, src=0, kbits=64, device=None):
    """(rows, n) int64: the kernel on a CUDA device, the plain version on
    the CPU. ``keys``: 64-bit seeds (Python ints); ``counter``: the draw."""
    device = torch.device(plain.device if plain is not None else device)
    if device.type != "cuda":
        return plain_philox(mode, keys, counter, n, plain, src, kbits, device)
    _check(mode, keys, n, plain, src, kbits)
    out = torch.empty((len(keys), n), dtype=torch.int64, device=device)
    if n == 0:
        return out
    seeds = (ctypes.c_uint64 * MAX_ROWS)(*[k & ((1 << 64) - 1) for k in keys])
    with torch.cuda.device(device):
        stream_ptr = torch.cuda.current_stream(device).cuda_stream
        rc = _lib().philox_launch(
            out.data_ptr(), n, len(keys), MODES[mode], seeds, counter & ((1 << 64) - 1),
            plain.data_ptr() if plain is not None else None, src, kbits, stream_ptr,
        )
    build.check(rc, "philox")
    launches[mode] = launches.get(mode, 0) + 1
    return out


def reset_launches():
    launches.clear()
