"""Wrapper of the CUDA seed-expansion kernel (``csrc/seed_expand.cu``) and
its plain version.

A seed-compressed 2-party sharing of an encoding w keeps only party 0's
share ``share0 = w - stream(key)``; party 1's share is ``stream(key)``,
regenerated at every use (``mpc/primitives/compressed.py``). ``stream(key)``
is the port's Philox4x32-10 stream of the tensor's 64-bit key at counter 0
(``kernels/philox.stream(key, 0, n)``): a pure function of (key, element
index). It will never equal the JAX package's threefry or ``rbg`` bits, nor
the TPU's hardware PRNG that its Pallas kernel draws from: compare decoded
values, never shares.

  compress(encoded, key)          share0 = encoded - stream(key)
  expand(share0, key, parties=2)  (2, *shape): row 0 share0, row 1 stream(key)
  expand(share0, key, parties=1)  (1, *shape): share0 + stream(key)
  open(share0, key, transposed, b_share)
                                  delta = share0 + stream(key) - b0 - b1 over
                                  y's view (stored, or transposed in its last
                                  two dims): the Beaver open of a compressed
                                  matmul operand y against the dealer's b

On a CUDA tensor each call is one launch of the kernel, which raises if it
fails; on a CPU tensor the plain version runs.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .philox import stream

MODES = {"compress": 0, "expand": 1, "expand1": 2}

# launches of the kernel, by mode ("open" for the open)
launches = {}


class _OpenArgs(ctypes.Structure):
    _fields_ = [
        ("delta", ctypes.c_void_p), ("share0", ctypes.c_void_p), ("b", ctypes.c_void_p),
        ("batches", ctypes.c_longlong), ("rows", ctypes.c_longlong), ("cols", ctypes.c_longlong),
        ("b_party", ctypes.c_longlong), ("b_batch", ctypes.c_longlong),
        ("b_row", ctypes.c_longlong), ("b_col", ctypes.c_longlong),
        ("key", ctypes.c_uint64), ("dense", ctypes.c_int),
    ]


def _lib():
    lib = build.load("seed_expand")
    if not getattr(lib, "_curl_bound", False):
        lib.seed_expand_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.seed_expand_launch.restype = ctypes.c_int
        lib.seed_open_launch.argtypes = [ctypes.POINTER(_OpenArgs), ctypes.c_int, ctypes.c_void_p]
        lib.seed_open_launch.restype = ctypes.c_int
        lib._curl_bound = True
    return lib


def _check(t: torch.Tensor, key: int, parties: int = 2):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64:
        raise ValueError("seed_expand takes an int64 tensor")
    if not t.is_contiguous():
        raise ValueError("seed_expand takes a contiguous tensor")
    if not 0 <= key < 1 << 64:
        raise ValueError(f"seed_expand key {key} is not a 64-bit unsigned integer")
    if parties not in (1, 2):
        raise ValueError(f"seed_expand expands to 1 or 2 parties, not {parties}")


def _stream(t: torch.Tensor, key: int) -> torch.Tensor:
    return stream(key, 0, t.numel(), t.device).reshape(t.shape)


def plain_compress(encoded: torch.Tensor, key: int) -> torch.Tensor:
    """The kernel's compress in plain torch (any device)."""
    _check(encoded, key)
    return encoded - _stream(encoded, key)


def plain_expand(share0: torch.Tensor, key: int, parties: int = 2) -> torch.Tensor:
    """The kernel's expand in plain torch (any device)."""
    _check(share0, key, parties)
    r = _stream(share0, key)
    if parties == 1:
        return (share0 + r).unsqueeze(0)
    return torch.stack([share0, r])


def _launch(mode: str, t: torch.Tensor, key: int, out: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError("the seed_expand kernel takes a CUDA tensor")
    if t.numel() == 0:
        return out
    with torch.cuda.device(t.device):
        st = torch.cuda.current_stream(t.device).cuda_stream
        rc = _lib().seed_expand_launch(out.data_ptr(), t.data_ptr(), t.numel(), key,
                                       MODES[mode], st)
    build.check(rc, "seed_expand")
    launches[mode] = launches.get(mode, 0) + 1
    return out


def launch_compress(encoded: torch.Tensor, key: int) -> torch.Tensor:
    """compress by the CUDA kernel."""
    _check(encoded, key)
    return _launch("compress", encoded, key, torch.empty_like(encoded))


def launch_expand(share0: torch.Tensor, key: int, parties: int = 2) -> torch.Tensor:
    """expand by the CUDA kernel."""
    _check(share0, key, parties)
    out = torch.empty((parties,) + tuple(share0.shape), dtype=torch.int64, device=share0.device)
    return _launch("expand" if parties == 2 else "expand1", share0, key, out)


def compress(encoded: torch.Tensor, key: int) -> torch.Tensor:
    """share0 = encoded - stream(key): the kernel on a CUDA tensor, the plain
    version on the CPU."""
    if encoded.device.type == "cuda":
        return launch_compress(encoded, key)
    return plain_compress(encoded, key)


def expand(share0: torch.Tensor, key: int, parties: int = 2) -> torch.Tensor:
    """(parties, *shape) shares of the compressed tensor: the kernel on a CUDA
    tensor, the plain version on the CPU."""
    if share0.device.type == "cuda":
        return launch_expand(share0, key, parties)
    return plain_expand(share0, key, parties)


def view_shape(share0: torch.Tensor, transposed: bool) -> tuple:
    """The shape of a compressed tensor's view: share0's, or with its last
    two dims swapped."""
    shape = tuple(share0.shape)
    return shape[:-2] + (shape[-1], shape[-2]) if transposed else shape


def _check_open(share0: torch.Tensor, key: int, transposed: bool, b_share: torch.Tensor):
    _check(share0, key)
    if transposed and share0.dim() < 2:
        raise ValueError("seed_expand open: a transposed view needs at least 2 dims")
    want = (2,) + view_shape(share0, transposed)
    if not isinstance(b_share, torch.Tensor) or b_share.dtype != torch.int64 \
            or tuple(b_share.shape) != want:
        raise ValueError(f"seed_expand open: b's shares must be int64 of shape {want}")
    if b_share.device != share0.device:
        raise ValueError("seed_expand open: share0 and b must lie on one device")


def plain_open(share0: torch.Tensor, key: int, transposed: bool,
               b_share: torch.Tensor) -> torch.Tensor:
    """The open in plain torch (any device): both parties' shares from
    plain_expand, viewed, less b's, summed over the parties; contiguous."""
    _check_open(share0, key, transposed, b_share)
    y = plain_expand(share0, key)
    if transposed:
        y = y.transpose(-1, -2)
    return (y[0] + y[1] - b_share[0] - b_share[1]).contiguous()


def launch_open(share0: torch.Tensor, key: int, transposed: bool,
                b_share: torch.Tensor) -> torch.Tensor:
    """The open by the CUDA kernel: b read through its strides, delta
    contiguous in the view's shape."""
    _check_open(share0, key, transposed, b_share)
    if share0.device.type != "cuda":
        raise ValueError("the seed_expand kernel takes a CUDA tensor")
    shape = view_shape(share0, transposed)
    delta = torch.empty(shape, dtype=torch.int64, device=share0.device)
    if delta.numel() == 0:
        return delta
    rows, cols = ((1, 1) + shape)[-2:]
    batches = delta.numel() // (rows * cols)
    b3 = b_share.reshape(2, batches, rows, cols)  # a view unless b's batch dims do not merge
    args = _OpenArgs(delta.data_ptr(), share0.data_ptr(), b3.data_ptr(), batches, rows, cols,
                     *b3.stride(), key, int(b_share[0].is_contiguous()))
    with torch.cuda.device(share0.device):
        st = torch.cuda.current_stream(share0.device).cuda_stream
        rc = _lib().seed_open_launch(ctypes.byref(args), int(transposed), st)
    build.check(rc, "seed_expand open")
    launches["open"] = launches.get("open", 0) + 1
    return delta


def open(share0: torch.Tensor, key: int, transposed: bool, b_share: torch.Tensor) -> torch.Tensor:
    """delta of the Beaver open of a compressed operand: the kernel on a
    CUDA tensor, the plain version on the CPU."""
    if share0.device.type == "cuda":
        return launch_open(share0, key, transposed, b_share)
    return plain_open(share0, key, transposed, b_share)


def reset_launches():
    launches.clear()
