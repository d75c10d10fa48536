"""Wrapper of the CUDA ring-matmul kernel (``csrc/ring_mm.cu``).

``ring_mm(pairs)`` computes ``sum_p A_p @ B_p mod 2^64`` on int64 CUDA
tensors in one launch: one pair is the TFP dealer product (replacing the
JAX package's ``pallas_ring_mm._kernel``), two pairs the Beaver
reconstruction ``eps @ b + x @ delta`` (replacing ``_acc_kernel``). Batch
dims broadcast as in torch.matmul; a broadcast operand keeps stride 0 and is
read in place by every batch slice. ``plain(pairs)`` is the same function by
the balanced-limb path of ``ring._plain_matmul``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

MAX_PAIRS = 4

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


def _lib():
    lib = build.load("ring_mm")
    if not getattr(lib, "_curl_bound", False):
        lib.ring_mm_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_MMArgs), ctypes.c_void_p,
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


def ring_mm(pairs) -> torch.Tensor:
    """sum_p A_p @ B_p mod 2^64 by the CUDA kernel (int64 CUDA tensors)."""
    pairs = [(a, b) for a, b in pairs]
    dev, M, N = _check(pairs)
    batch = torch.broadcast_shapes(*[t.shape[:-2] for ab in pairs for t in ab])
    b0 = batch[0] if len(batch) >= 1 else 1
    b1 = math.prod(batch[1:]) if len(batch) >= 2 else 1
    if b0 * b1 > 65535:
        raise ValueError(f"ring_mm batch {tuple(batch)} exceeds the grid's z limit")
    out = torch.empty(tuple(batch) + (M, N), dtype=torch.int64, device=dev)
    if out.numel() == 0:
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
        rc = _lib().ring_mm_launch(out.data_ptr(), b0, b1, M, N, ctypes.byref(args), stream)
    build.check(rc, "ring_mm")
    launches[len(pairs)] = launches.get(len(pairs), 0) + 1
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
