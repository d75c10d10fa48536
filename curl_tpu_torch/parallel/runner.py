"""Party runtimes: the private forward run as one program, or eagerly.

Counterpart of ``curl_tpu/parallel/runner.py``'s single-device runners. The
JAX package binds its per-party protocol code with ``jax.vmap`` over a party
axis and ``compile_parties`` jits the whole multi-party forward into one XLA
program, with fresh protocol randomness per seed. The port's shares already
carry the party axis, so the binding is only the session's keys and world
size (``mpc_context``), and the port's counterpart of a jitted program is a
captured CUDA graph:

  * ``run_parties(fn, world_size, seed, *args)`` runs ``fn`` eagerly under
    the keys of ``seed``;
  * ``compile_parties(fn, world_size)`` returns a runner ``(seed, *args) ->
    outputs``. On a CUDA session its first call runs one eager warm-up
    forward on a side stream (which builds the kernels and makes the public
    constants), then captures ``fn`` once under ``torch.cuda.graph``; every
    call writes the seed's stream keys into the session key table
    (``random.TABLE``), which the kernels read on the device, replays the
    graph, restores the session's keys and returns clones of the output
    shares. A session started with ``device="cpu"`` runs ``fn`` eagerly
    under the call's keys instead, from the same draw counter each time;
  * ``compile_parties_cached(fn, world_size, seed, *args)`` returns
    ``(online, fill)``, the offline/online split: ``fill(seed)`` generates
    every tuple request a recording run of ``fn`` made, and
    ``online(seed, cache, *args)`` runs ``fn`` served from that cache, each
    a ``CompiledParties`` program.

Arguments are pytrees (dicts, lists, tuples) of MPCTensors, share tensors,
torch tensors and Python values; ``Public(x)`` marks a public value (passed
to ``fn`` as ``x``). A graph bakes the draw counters, the shapes, strides
and dtypes of its inputs, Python values, public values that are not
tensors, and each seed-compressed tensor's key. It reads each tensor
argument in place, at the address it had at capture, so a model's
parameters are never copied; an argument that comes at another address is
captured anew once, read from then on through a static buffer that each
call copies it into (the tokens of a new request). A call that differs
from a captured one in any of these captures anew, keyed by all of them; a
graph is never replayed over values it baked differently.

``fn`` receives fresh wrappers (MPCTensors, shared tensors) of the
arguments' tensors at each run, the warm-up's and the capture's apart, as
a jitted function receives fresh tracers: a training step that sets its
parameters' ``requires_grad``, accumulates their gradients and swaps their
shares (``optim.SGD``) changes neither the caller's objects nor what the
capture reads. A training step returns its new parameters (its
``params_pytree``) and its loss; the next call passes those in, at new
addresses, so it captures anew once and then reads them through its
static buffers, and each replay trains on from the last.

CommStats are counted once, at capture, as curl_tpu counts them once at
trace; so are the kernels' launch counts. The runner keeps the capture's
CommStats (``stats``); ``count_each_call=True`` counts them again at every
call that does not capture (the lazy scope's flushes, which curl_tpu traces
anew each time). Tensors that ``fn`` reaches other than through its
arguments are read in place, at the address they had at capture; the
public constants that the warm-up made are kept with the graph
(``ring.holding_constants``).
"""

from __future__ import annotations

import contextlib
import numbers
import time
from dataclasses import dataclass
from typing import Any

import torch

from .. import comm
from .. import random as rng
from .. import ring
from ..kernels import fused_mul, max_step, philox, ring_mm, seed_expand
from ..mpc.mpc import MPCTensor
from ..mpc.primitives.arithmetic import ArithmeticSharedTensor
from ..mpc.primitives.binary import BinarySharedTensor
from ..mpc.primitives.compressed import SeedCompressedArithmetic
from ..mpc.provider.provider import TupleCache

# the kernels whose launches a capture counts, by the JSON line's family
_KERNELS = {"ring_mm": ring_mm, "philox": philox, "fused_mul": fused_mul,
            "max_step": max_step, "seed_expand": seed_expand}


@dataclass
class Public:
    """Wrapper marking an argument as public (identical across parties)."""

    value: Any


@contextlib.contextmanager
def mpc_context(keys, world_size: int, runtime: str = "vmap"):
    """Bind stream keys (``random.make_party_keys``'s) and the world size
    for the protocol code run inside: the key table is written in place, on
    the host and on the device in stream order, and restored on exit.
    ``runtime="shard_map"``, one party per device, is queue item A15 and
    not ported."""
    if runtime != "vmap":
        raise NotImplementedError(f"runtime {runtime!r} is not ported yet (ROADMAP A15)")
    old_ws, old_keys = comm.get_world_size(), rng.session_keys()
    comm.set_world_size(world_size)
    rng.set_keys(keys)
    try:
        yield
    finally:
        comm.set_world_size(old_ws)
        if old_keys is not None:
            rng.set_keys(old_keys)


def _provider():
    from ..mpc import get_default_provider

    return get_default_provider()


def _party_keys(seed, world_size: int) -> dict:
    if not isinstance(seed, numbers.Integral):
        raise TypeError(f"a seed is an integer, not {type(seed).__name__}")
    return rng.make_party_keys(int(seed), world_size)


# ---------------------------------------------------------------------------
# pytrees: structure and leaves
# ---------------------------------------------------------------------------

def _layout(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.stride(), t.dtype, str(t.device))


def _flatten(x, leaves: list):
    """A hashable spec of ``x``, its tensors appended to ``leaves``: a
    tensor (a share, a plain tensor, a compressed tensor's share0) as
    ("tensor", index, layout); every other value as ("const", value)."""
    if isinstance(x, Public):
        return ("public", _flatten(x.value, leaves))
    if isinstance(x, dict):
        return ("dict", tuple(x), tuple(_flatten(v, leaves) for v in x.values()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, MPCTensor):
        return ("mpc", x.ptype, _flatten(x._tensor, leaves))
    if isinstance(x, SeedCompressedArithmetic):
        return ("compressed", x.key, x.transposed, x.encoder.precision_bits,
                _flatten(x.share0, leaves))
    if type(x) in (ArithmeticSharedTensor, BinarySharedTensor):
        kind = "arith" if isinstance(x, ArithmeticSharedTensor) else "binary"
        return (kind, x.encoder.precision_bits, _flatten(x.share, leaves))
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", len(leaves) - 1, _layout(x))
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"compile_parties cannot key a graph on a {type(x).__name__}: "
                        "pass tensors, MPCTensors, Python scalars or Public(...)") from None
    return ("const", x)


def _build(spec, leaves, public: bool = False):
    """The value of ``spec`` over ``leaves``; ``public``: Public values
    unwrapped (what ``fn`` receives)."""
    from ..encoder import FixedPointEncoder

    kind = spec[0]
    if kind == "public":
        inner = _build(spec[1], leaves, public)
        return inner if public else Public(inner)
    if kind == "dict":
        return {k: _build(v, leaves, public) for k, v in zip(spec[1], spec[2])}
    if kind in ("list", "tuple"):
        items = [_build(v, leaves, public) for v in spec[1]]
        return items if kind == "list" else tuple(items)
    if kind == "mpc":
        return MPCTensor(_build(spec[2], leaves, public), spec[1])
    if kind == "compressed":
        _, key, transposed, bits, share0 = spec
        return SeedCompressedArithmetic(_build(share0, leaves), key, FixedPointEncoder(bits),
                                        transposed)
    if kind == "arith":
        return ArithmeticSharedTensor(_build(spec[2], leaves, public), FixedPointEncoder(spec[1]))
    if kind == "binary":
        return BinarySharedTensor(_build(spec[2], leaves, public), FixedPointEncoder(spec[1]))
    if kind == "tensor":
        return leaves[spec[1]]
    return spec[1]


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------

def _counts() -> dict:
    """The CommStats and every kernel's launch counts, as they stand."""
    return {"stats": (comm.comm_stats.rounds, comm.comm_stats.bytes,
                      dict(comm.comm_stats.calls)),
            "launches": {name: dict(mod.launches) for name, mod in _KERNELS.items()}}


def _restore(counts: dict):
    comm.comm_stats.rounds, comm.comm_stats.bytes, calls = counts["stats"]
    comm.comm_stats.calls = dict(calls)
    for name, mod in _KERNELS.items():
        mod.launches.clear()
        mod.launches.update(counts["launches"][name])


@contextlib.contextmanager
def _uncounted():
    """Run without leaving a trace in CommStats or the launch counts."""
    before = _counts()
    try:
        yield
    finally:
        _restore(before)


def _since(before: dict) -> dict:
    """The CommStats counted since ``before``."""
    rounds, nbytes, calls = _counts()["stats"]
    r0, b0, c0 = before["stats"]
    return {"rounds": rounds - r0, "bytes": nbytes - b0,
            "calls": {k: n - c0.get(k, 0) for k, n in calls.items() if n != c0.get(k, 0)}}


# ---------------------------------------------------------------------------
# the runners
# ---------------------------------------------------------------------------

def _unwrap(args):
    return [a.value if isinstance(a, Public) else a for a in args]


def run_parties(fn, world_size: int, seed, *args, jit: bool = False):
    """Run ``fn(*args)`` as ``world_size`` parties under the keys of
    ``seed``, eagerly (``jit=True``: one call of ``compile_parties``).
    ``Public(x)`` arguments reach ``fn`` as ``x``. Draws continue from the
    session's draw counter, as the JAX package's trace counter does."""
    if jit:
        return compile_parties(fn, world_size)(seed, *args)
    with mpc_context(_party_keys(seed, world_size), world_size), _provider().serving(None):
        return fn(*_unwrap(args))


class _Capture:
    """One captured call: its draw counter and CommStats, and on a card the
    graph, the addresses of the arguments it reads in place, the static
    buffers of those it reads through a copy, its outputs and the
    constants it reads."""

    def __init__(self, counter: int):
        self.counter = counter
        self.stats = self.graph = self.out = self.out_spec = None
        self.inplace, self.staged, self.held = {}, {}, {}


def _stage(entry: _Capture, leaves: list, staged: set, device) -> list:
    """The tensors a capture reads: a static buffer (a copy) for each leaf
    at ``staged``, every other leaf itself, its address kept."""
    static = list(leaves)
    for i in staged:
        static[i] = torch.empty_like(leaves[i], device=device)
        static[i].copy_(leaves[i])
        entry.staged[i] = static[i]
    entry.inplace = {i: t.data_ptr() for i, t in enumerate(leaves) if i not in staged}
    return static


class CompiledParties:
    """The runner ``compile_parties`` returns: ``(seed, *args) -> outputs``.

    ``captures`` counts the captures made; ``stats`` is the CommStats
    counted by the latest one, ``counter`` its first draw counter,
    ``constants`` the public constants its graph reads, and ``warmup_s``
    and ``capture_s`` the host seconds of its warm-up forward and of the
    capture with the graph's instantiation (None on the CPU). Each call's
    outputs are copies of the graph's (``copy_out=False``: the graph's own
    tensors, which the next replay rewrites).

    ``fn`` runs with no tuple cache bound (``provider.serving(None)``): its
    provider calls generate their tuples inline, even where eager ops are
    served from a host cache. ``count_each_call``: every call that replays
    (or, on the CPU, reruns) a capture counts its CommStats again."""

    def __init__(self, fn, world_size: int, copy_out: bool = True,
                 count_each_call: bool = False):
        self.fn = fn
        self.world_size = world_size
        self.copy_out = copy_out
        self.count_each_call = count_each_call
        self.captures = 0
        self.stats = self.counter = self.constants = self.warmup_s = self.capture_s = None
        self._entries = {}

    def __call__(self, seed, *args):
        leaves = []
        spec = _flatten(tuple(args), leaves)
        return self._call(seed, spec, leaves, args)

    def _call(self, seed, spec, leaves, args):
        keys = _party_keys(seed, self.world_size)
        device = comm.get_device()
        key = (str(device), spec)
        entry = self._entries.get(key)
        if device.type != "cuda":
            return self._eager(key, entry, keys, spec, leaves)
        staged, counter = set(), rng.counter()
        if entry is not None:
            moved = {i for i, ptr in entry.inplace.items() if leaves[i].data_ptr() != ptr}
            if not moved:
                self._recount(entry)
                return self._replay(entry, leaves, keys)
            # read through static buffers from now on, at the same draw
            # counters: where an argument lies does not change a call's shares
            staged, counter = set(entry.staged) | moved, entry.counter
            del self._entries[key]
            entry = None  # the old graph and its pool go first
        entry = self._capture(key, spec, leaves, staged, keys, device, counter)
        return self._replay(entry, leaves, keys)

    def _recount(self, entry):
        if self.count_each_call:
            comm.add_communication_stats(entry.stats)

    def _record(self, key, entry, before):
        entry.stats = _since(before)
        self._entries[key] = entry
        self.captures += 1
        self.stats, self.counter, self.constants = entry.stats, entry.counter, len(entry.held)

    def _eager(self, key, entry, keys, spec, leaves):
        """The plain path (a CPU session): ``fn`` eagerly under ``keys``,
        from the first call's draw counter, over fresh wrappers of the
        arguments' tensors; only the first call counts."""
        args = _build(spec, leaves, public=True)
        if entry is None:
            entry = _Capture(rng.counter())
            before = _counts()
            with mpc_context(keys, self.world_size), _provider().serving(None):
                out = self.fn(*args)
            self._record(key, entry, before)
            return out
        resume = rng.counter()
        rng.set_counter(entry.counter)
        try:
            with _uncounted(), mpc_context(keys, self.world_size), _provider().serving(None):
                out = self.fn(*args)
        finally:
            rng.set_counter(resume)
        self._recount(entry)
        return out

    def _capture(self, key, spec, leaves, staged, keys, device, counter):
        """Warm up and capture ``fn`` over ``leaves``, drawing from
        ``counter`` on: those at ``staged`` through static buffers, every
        other one in place. The session's counter ends past both the
        capture's draws and its own."""
        resume = rng.counter()
        entry = _Capture(counter)
        rng.set_counter(counter)
        static = _stage(entry, leaves, staged, device)
        graph = torch.cuda.CUDAGraph()
        with mpc_context(keys, self.world_size), ring.holding_constants(entry.held), \
                _provider().serving(None):
            # the warm-up builds the kernels, makes the constants and the
            # table's device copy; it is counted nowhere
            t0 = time.perf_counter()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side), _uncounted():
                self.fn(*_build(spec, static, public=True))
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            self.warmup_s = time.perf_counter() - t0
            rng.set_counter(entry.counter)
            # fresh wrappers: what the warm-up left on them (a training
            # step's gradients, its parameters' swapped shares) stays there
            args = _build(spec, static, public=True)
            before = _counts()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, capture_error_mode="global"):
                out = self.fn(*args)
            self.capture_s = time.perf_counter() - t0
        rng.set_counter(max(resume, rng.counter()))
        out_leaves = []
        entry.out_spec = _flatten(out, out_leaves)
        entry.out, entry.graph = out_leaves, graph
        self._record(key, entry, before)
        return entry

    def _replay(self, entry, leaves, keys):
        for i, buf in entry.staged.items():
            buf.copy_(leaves[i])
        with mpc_context(keys, self.world_size):
            entry.graph.replay()
        out = [t.clone() for t in entry.out] if self.copy_out else entry.out
        return _build(entry.out_spec, out)


def compile_parties(fn, world_size: int, jit: bool = True):
    """A reusable runner: ``(seed, *args) -> outputs``, fresh protocol
    randomness per seed (``CompiledParties``). ``jit=True`` means a
    captured CUDA graph on a CUDA session (a capture that fails raises; the
    runner never carries on eagerly there) and ``fn`` run eagerly under the
    call's keys on a CPU session; ``jit=False`` runs every call eagerly
    (``run_parties``)."""
    if not jit:
        return lambda seed, *args: run_parties(fn, world_size, seed, *args)
    return CompiledParties(fn, world_size)


class CachedOnline(CompiledParties):
    """The online program of ``compile_parties_cached``: ``(seed, cache,
    *args) -> outputs``, ``fn`` served from ``cache`` in order. One capture
    reads the cache's tensors in place at their capture address, as a
    model's parameters are read; each run (the warm-up, the capture, and
    an eager call on a CPU session) takes a view of the entries from entry
    0. A serving run never generates a tuple: a request past the cache's
    end raises "exhausted", and a run that leaves entries unserved raises
    too (its requests are not the recorded ones)."""

    def __init__(self, fn, world_size: int):
        provider = _provider()

        def served(entries, *inner):
            view = TupleCache(entries)
            with provider.serving(view):
                out = fn(*inner)
            if view.cursor != len(entries):
                raise RuntimeError(f"the serving run took {view.cursor} of the cache's "
                                   f"{len(entries)} tuples: its requests are not the recorded ones")
            return out

        super().__init__(served, world_size)

    def __call__(self, seed, cache: TupleCache, *args):
        if cache.overwritten:
            raise RuntimeError("this cache's tensors hold a later fill's tuples")
        if cache._flat is None:  # flattened once a cache: a fill's many tensors
            leaves = []
            cache._flat = (_flatten(cache.entries, leaves), leaves)
        spec0, leaves = cache._flat[0], list(cache._flat[1])
        spec = ("tuple", (spec0,) + tuple(_flatten(a, leaves) for a in args))
        out = self._call(seed, spec, leaves, (cache.entries,) + args)
        cache.cursor = len(cache.entries)
        return out


class CachedFill:
    """The offline program of ``compile_parties_cached``: ``fill(seed) ->
    TupleCache``, every recorded request generated under the keys of
    ``seed`` (``CompiledParties`` over ``fill_cache_entries``: one CUDA
    graph on a CUDA session, replayed a call; eager on a CPU session, from
    the first call's draw counter). On a card every fill writes the same
    tensors, the graph's own: the cache a fill returns is marked
    ``overwritten`` by the next one, which the online refuses, and the
    online graph, reading them in place, needs no capture anew."""

    def __init__(self, requests, world_size: int):
        provider = _provider()
        self.requests = requests = list(requests)
        self.funcs = [r.func for r in requests]
        # the program holds the requests, not self: no cycle keeps a
        # dropped fill's graph and tuples alive until a garbage collection
        self.program = CompiledParties(lambda: provider.fill_cache_entries(requests),
                                       world_size, copy_out=False)
        self._issued = None

    def __call__(self, seed) -> TupleCache:
        entries = self.program(seed)
        if comm.get_device().type == "cuda" and self._issued is not None:
            self._issued.overwritten = True
        self._issued = TupleCache(entries, funcs=self.funcs)
        return self._issued


def compile_parties_cached(fn, world_size: int, seed, *args):
    """The offline/online split (runner.py:146-213; the reference's tuple
    cache, curl/mpc/provider/provider.py:47-157, as two programs):

      1. ``fn(*args)`` run once at ``seed``, eagerly on the session's
         device, recording every tuple request (``trace(True)``; counted
         nowhere), where the JAX package shape-evaluates it;
      2. ``fill(seed) -> cache``: the recorded requests generated
         (``CachedFill``), the dealer's phase;
      3. ``online(seed, cache, *args) -> outputs``: ``fn`` served from the
         cache (``CachedOnline``); its CommStats are counted at its capture.

    Returns ``(online, fill)``. Each program draws from the counter of its
    first call (its capture on a card), after the recording's draws: the
    fill's and the online's draws never share a counter, whatever seeds
    they are given. Give the two programs distinct seeds all the same, as
    bench.py does."""
    provider = _provider()
    provider.requests = []
    provider.trace(True)
    try:
        with _uncounted():
            run_parties(fn, world_size, seed, *args)
    finally:
        provider.trace(False)
    return CachedOnline(fn, world_size), CachedFill(provider.requests, world_size)


def shard_map_parties(fn, mesh, world_size: int):
    """One party per device: queue item A15."""
    raise NotImplementedError("shard_map_parties is not ported yet (ROADMAP A15)")


def run_parties_spmd(fn, mesh, world_size: int, seed, *args, jit: bool = True):
    """One party per device: queue item A15."""
    raise NotImplementedError("run_parties_spmd is not ported yet (ROADMAP A15)")
