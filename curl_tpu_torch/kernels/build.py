"""Build the CUDA kernels of ``curl_tpu_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/curl_tpu_torch/<name>-<hash>.so

under ``build/`` at the root of the checkout. The file name carries a hash
of the source and of every local header it includes (``#include "..."``,
followed recursively), so an edited source or header rebuilds and an
unchanged one is loaded as it is. ``build_all`` starts one nvcc per source,
all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "curl_tpu_torch")
KERNELS = ("ring_mm", "philox", "fused_mul", "max_step", "seed_expand")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs = {}
_lock = threading.Lock()
# ptxas register / spill report of each build, by kernel name
build_logs = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: str, seen: list) -> list:
    """``path`` and every local header it includes, recursively, in the
    order first met."""
    path = os.path.normpath(path)
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        _sources(os.path.join(os.path.dirname(path), inc.decode()), seen)
    return seen


def _target(name: str) -> str:
    h = hashlib.sha256()
    for path in _sources(os.path.join(CSRC_DIR, f"{name}.cu"), []):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, target: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, target: str, proc: subprocess.Popen):
    out, _ = proc.communicate()
    build_logs[name] = out
    tmp = f"{target}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)


def build_all(names=KERNELS) -> float:
    """Compile every listed kernel whose library is missing, one nvcc each,
    all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = []
        for name in names:
            target = _target(name)
            if not os.path.exists(target):
                jobs.append((name, target, _start(name, target)))
        for name, target, proc in jobs:
            _finish(name, target, proc)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_target(name))
        return _libs[name]


def check(rc: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")
