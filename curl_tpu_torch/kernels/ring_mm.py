"""Wrapper of the CUDA ring-matmul kernel (``csrc/ring_mm.cu``).

``ring_mm(pairs)`` computes ``sum_p A_p @ B_p mod 2^64`` on int64 CUDA
tensors in one launch: one pair is the TFP dealer product (replacing the
JAX package's ``pallas_ring_mm._kernel``), two pairs the Beaver
reconstruction ``eps @ b + x @ delta`` (replacing ``_acc_kernel``). Batch
dims broadcast as in torch.matmul; a broadcast operand keeps stride 0 and is
read in place by every batch slice. The kernel contracts balanced int8 limb
planes on the tensor cores into int32 diagonal sums; ``split_k`` cuts the
summed k into chunks of at most ``FLUSH_K``, so that a launch fills the card
and no int32 sum can overflow. ``plain(pairs)`` is the same function by the
balanced-limb path of ``ring._plain_matmul``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

MAX_PAIRS = 4
TILE_M = TILE_N = 64  # a block's output tile
TILE_K = 32  # k of one tensor-core step; each pair's K is cut into such tiles
# Summed k (over all pairs) that a block contracts before it folds its int32
# diagonal sums into 64-bit values: a diagonal adds at most 8 digit products
# of at most 2^14 per k, and 8 * 8192 * 2^14 = 2^30 < 2^31.
FLUSH_K = 8192
H100_SMS = 132
# a block's fixed cost (pipeline fill, fold and stores) in 32-k steps, for split_k
_BLOCK_STEPS = 2

# launches of the kernel, by number of pairs
launches = {}


class _Operand(ctypes.Structure):
    _fields_ = [
        ("ptr", ctypes.c_void_p),
        ("s0", ctypes.c_longlong),
        ("s1", ctypes.c_longlong),
        ("sr", ctypes.c_longlong),
        ("sc", ctypes.c_longlong),
    ]


class _MMArgs(ctypes.Structure):
    _fields_ = [
        ("a", _Operand * MAX_PAIRS),
        ("b", _Operand * MAX_PAIRS),
        ("k", ctypes.c_longlong * MAX_PAIRS),
        ("n_pairs", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def split_k(out_tiles: int, k_tiles: int, sms: int = H100_SMS):
    """(chunk, splits): 32-k tiles of the summed k a block contracts, and
    blocks per output tile, for a launch of ``out_tiles`` 64 x 64 tiles over
    ``k_tiles`` tiles of summed k on ``sms`` SMs (one block each).

    No chunk exceeds FLUSH_K. Where the summed k is long enough, the launch
    has at least ``sms`` blocks; among such cuts the one with the fewest
    steps on the busiest SM (waves x (chunk + a block's fixed cost)) wins,
    the fewer splits on a tie."""
    best = None
    for chunk in range(1, min(k_tiles, FLUSH_K // TILE_K) + 1):
        splits = -(-k_tiles // chunk)
        blocks = out_tiles * splits
        cost = (blocks < sms, -(-blocks // sms) * (chunk + _BLOCK_STEPS), splits)
        if best is None or cost < best[0]:
            best = (cost, chunk, splits)
    return best[1], best[2]


_sms = {}


def _sm_count(dev) -> int:
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev.index]


def _lib():
    lib = build.load("ring_mm")
    if not getattr(lib, "_curl_bound", False):
        lib.ring_mm_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_MMArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.ring_mm_launch.restype = ctypes.c_int
        lib._curl_bound = True
    return lib


def _batch_strides(t: torch.Tensor, batch):
    """(s0, s1) so that batch index (g0, g1) of ``t`` expanded to ``batch``
    starts at g0*s0 + g1*s1, g1 flattening batch[1:]; None where the inner
    batch dims cannot be flattened into one stride."""
    t = t.expand(tuple(batch) + tuple(t.shape[-2:]))
    nb = len(batch)
    s0 = t.stride(0) if nb >= 1 else 0
    inner = [(t.shape[d], t.stride(d)) for d in range(1, nb) if t.shape[d] != 1]
    for (_, s_hi), (n_lo, s_lo) in zip(inner, inner[1:]):
        if s_hi != s_lo * n_lo:
            return None
    s1 = inner[-1][1] if inner else 0
    return s0, s1


def _check(pairs):
    if not 1 <= len(pairs) <= MAX_PAIRS:
        raise ValueError(f"ring_mm takes 1 to {MAX_PAIRS} pairs, got {len(pairs)}")
    dev = pairs[0][0].device
    M, N = pairs[0][0].shape[-2], pairs[0][1].shape[-1]
    for a, b in pairs:
        for t in (a, b):
            if t.dtype != torch.int64:
                raise TypeError(f"ring_mm takes int64 tensors, got {t.dtype}")
            if t.device != dev or t.device.type != "cuda":
                raise ValueError("ring_mm operands must lie on one CUDA device")
            if t.ndim < 2:
                raise ValueError("ring_mm operands must be at least 2-D")
        if a.shape[-1] != b.shape[-2] or a.shape[-2] != M or b.shape[-1] != N:
            raise ValueError(f"ring_mm shape mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    return dev, M, N


def plan(pairs, sms: int = H100_SMS) -> dict:
    """The launch of ``pairs`` (shapes only, any device): the broadcast
    batch and its (b0, b1) grid, the output and k tiles, and split_k's
    (chunk, splits) for ``sms`` SMs. Pairs with K = 0 add nothing and have
    no tiles."""
    batch = torch.broadcast_shapes(*[t.shape[:-2] for ab in pairs for t in ab])
    b0 = batch[0] if len(batch) >= 1 else 1
    b1 = math.prod(batch[1:]) if len(batch) >= 2 else 1
    M, N = pairs[0][0].shape[-2], pairs[0][1].shape[-1]
    k_tiles = sum(-(-a.shape[-1] // TILE_K) for a, _ in pairs)
    out_tiles = -(-M // TILE_M) * -(-N // TILE_N) * b0 * b1
    chunk, splits = split_k(out_tiles, k_tiles, sms) if k_tiles and out_tiles else (1, 0)
    return dict(batch=batch, b0=b0, b1=b1, M=M, N=N, out_tiles=out_tiles, k_tiles=k_tiles,
                chunk=chunk, splits=splits)


def ring_mm(pairs) -> torch.Tensor:
    """sum_p A_p @ B_p mod 2^64 by the CUDA kernel (int64 CUDA tensors)."""
    pairs = [(a, b) for a, b in pairs]
    n_pairs = len(pairs)
    dev, M, N = _check(pairs)
    g = plan(pairs, _sm_count(dev))
    batch, b0, b1 = g["batch"], g["b0"], g["b1"]
    if b0 * b1 > 65535:
        raise ValueError(f"ring_mm batch {tuple(batch)} exceeds the grid's z limit")
    # several chunks add into the output with atomics
    alloc = torch.zeros if g["splits"] != 1 else torch.empty
    out = alloc(tuple(batch) + (M, N), dtype=torch.int64, device=dev)
    pairs = [(a, b) for a, b in pairs if a.shape[-1] > 0]
    if not g["splits"]:
        return out
    args = _MMArgs()
    args.n_pairs = len(pairs)
    keep = []  # operands must outlive the launch call
    for p, (a, b) in enumerate(pairs):
        args.k[p] = a.shape[-1]
        for slot, t in ((args.a, a), (args.b, b)):
            strides = _batch_strides(t, batch)
            if strides is None:
                t = t.expand(tuple(batch) + tuple(t.shape[-2:])).contiguous()
                strides = _batch_strides(t, batch)
            keep.append(t)
            slot[p] = _Operand(t.data_ptr(), strides[0], strides[1], t.stride(-2), t.stride(-1))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().ring_mm_launch(out.data_ptr(), b0, b1, M, N, ctypes.byref(args), g["chunk"],
                                   FLUSH_K, int(g["splits"] > 1), stream)
    build.check(rc, "ring_mm")
    launches[n_pairs] = launches.get(n_pairs, 0) + 1
    return out


def plain(pairs) -> torch.Tensor:
    """The kernel's function by the balanced-limb path, on any device."""
    from ..ring import _plain_matmul

    pairs = list(pairs)
    out = _plain_matmul(*pairs[0])
    for a, b in pairs[1:]:
        out = out + _plain_matmul(a, b)
    return out


def reset_launches():
    launches.clear()
