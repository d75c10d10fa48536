"""Where ring_mm's time goes on the card: the kernel beside variants of it
that leave parts of its step out.

    python3 -m curl_tpu_torch.kernels.ring_mm_breakdown

Each variant is ``csrc/ring_mm.cu`` with some of its step deleted (the
copies into the staging ring, the split into limb planes, the wgmma
products), built with the kernels' nvcc flags under
``build/curl_tpu_torch/breakdown/``. A variant's results are wrong; its time
says what the deleted parts cost. The shapes are the path's main products and
a steady-state one whose 132 blocks each contract one whole FLUSH_K chunk.
Each time is the median of 5 runs, each after an L2 flush (CUDA events).
Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import math
import os
import statistics
import subprocess

import torch

from . import build, ring_mm

_LOADS = ("cur.load(staging0 + s * 2 * kStageBytes);",)
_SPLIT = ("split(stage, planes, r, q + 2 * h);",
          "split(stage + kStageBytes, planes + kPlaneSet, r, q + 2 * h);")
_PRODUCTS = ("wgmma_s8(acc[d], frag[i], smem_desc(b_planes + (diag<W>(d) - i) * kPlaneBytes));",)
# variant: the lines it deletes
VARIANTS = {"loads only": _SPLIT + _PRODUCTS, "split only": _LOADS + _PRODUCTS,
            "products only": _LOADS + _SPLIT, "none": _LOADS + _SPLIT + _PRODUCTS}


def _c(*shape):
    return (shape, torch.empty(shape, device="meta").stride())


def _beaver(m, k, n):
    # eps @ b + x @ delta, delta of a materialized Linear's weight.t()
    # (column-major; the open of a compressed weight writes it row-major)
    return [_c(1, m, k) + _c(2, 1, k, n), _c(2, 1, m, k) + ((k, n), (1, k))]


SHAPES = {
    "steady (64,8192)@(8192,8448)": [_c(64, 8192) + _c(8192, 132 * 64)],
    "GPT-Neo block (1,64,2048)@(2048,2048)": [_c(1, 64, 2048) + _c(2048, 2048)],
    "GPT-Neo block, Beaver": _beaver(64, 2048, 2048),
    "GPT-2 FFN down, Beaver": _beaver(64, 3072, 768),
    "GPT-2 QKV, Beaver": _beaver(64, 768, 2304),
}


def _variants():
    """{name: loaded library} of the deleting variants, built in parallel."""
    src = open(os.path.join(build.CSRC_DIR, "ring_mm.cu")).read()
    out_dir = os.path.join(build.BUILD_DIR, "breakdown")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, lines in VARIANTS.items():
        text = src
        for line in lines:
            if line not in text:
                raise RuntimeError(f"ring_mm_breakdown: csrc/ring_mm.cu no longer has {line!r}")
            text = text.replace(line, ";")
        stem = os.path.join(out_dir, name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        procs[name] = (stem, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        lib = ctypes.CDLL(stem + ".so")
        lib.ring_mm_launch.argtypes = ring_mm._lib().ring_mm_launch.argtypes
        lib.ring_mm_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _cold_ms(fn, reps=5):
    """Median device ms of ``fn``, each run after an L2 flush and queued
    behind a spin kernel, so that the events time the device's work and not
    the host's launch overhead."""
    flush = torch.ones(50 * 2 ** 20, dtype=torch.int64, device="cuda")  # 400 MB > L2
    fn()
    times = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(2_000_000)  # about a millisecond
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ring_mm_breakdown needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[breakdown] {smi}", flush=True)
    own_lib = ring_mm._lib
    kernel = own_lib()
    libs = {"kernel": kernel, **_variants()}
    gen = torch.Generator().manual_seed(3)
    try:
        for name, sig in SHAPES.items():
            pairs = []
            for sa, st_a, sb, st_b in sig:
                ops = []
                for shape, stride in ((sa, st_a), (sb, st_b)):
                    span = 1 + sum((n - 1) * s for n, s in zip(shape, stride))
                    flat = torch.randint(-(2 ** 63), 2 ** 63 - 1, (span,), generator=gen)
                    ops.append(flat.to(dev).as_strided(shape, stride))
                pairs.append(tuple(ops))
            ring_mm._lib = lambda: kernel
            out = ring_mm.ring_mm(pairs)
            exact = torch.equal(out, ring_mm.plain(pairs))
            # the least time: each input element read once, the output written
            # once, at 3.35 TB/s; or 36 int8 plane products of 2 operations a
            # ring multiply-accumulate at 1,979 TOPS
            reads = sum(math.prod(n for n, st in zip(t.shape, t.stride()) if st) for ab in pairs
                        for t in ab)
            t_bytes = (reads + out.numel()) * 8 / 3.35e12 * 1e3
            t_ops = 72 * sum(out.numel() * a.shape[-1] for a, _ in pairs) / 1979e12 * 1e3
            times = {}
            for lname, lib in libs.items():
                ring_mm._lib = lambda lib=lib: lib
                times[lname] = _cold_ms(lambda: ring_mm.ring_mm(pairs))
            g = ring_mm.plan(pairs, torch.cuda.get_device_properties(dev).multi_processor_count)
            by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"[breakdown] {name} (bit-exact {exact}; {g['out_tiles']} output tiles x "
                  f"{g['splits']} chunks of {g['chunk']} 32-k tiles; bound "
                  f"{max(t_bytes, t_ops):.4f} ms by {by}): "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)
            del pairs, out
            torch.cuda.empty_cache()
    finally:
        ring_mm._lib = own_lib


if __name__ == "__main__":
    main()
