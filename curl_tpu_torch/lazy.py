"""Lazy eager batching: record MPCTensor ops, replay them as one program.

Counterpart of ``curl_tpu/lazy.py``. The eager API (``x.matmul(w).gelu()``)
dispatches every op from the host, and on a CUDA card the host is what
bounds it: the device idles through most of an eager forward. Inside a
scope the ops are recorded instead, and the recorded graph runs as one
captured CUDA graph at the first materialization:

    with curl_tpu_torch.lazy():
        h = model(xe)
        p = h.softmax(-1)
    p.get_plain_text()              # one flush ran the whole scope

Each op called on an MPCTensor inside a scope (``autograd``'s method
dispatch, ``MPCTensor.cat``/``stack``, ``__getitem__``, and any function
passed through ``call``) is shape-evaluated on the ``meta`` device and
hands out pending MPCTensors (``mpc/mpc.py``), whose shape, ptype and
encoder are known without running anything; the evaluation is kept by
(op, static arguments, the inputs' kinds, shapes and encoders, the config),
so a repeated scope records without evaluating. Only the outermost call is
recorded: while an op is evaluated, replayed or flushed, the calls it makes
run directly.

The first read of a pending tensor's shares (``share``, ``reveal``,
``get_plain_text``, an op outside the scope) or the scope's exit flushes
the tape: one function over the recorded nodes, its arguments the scope's
concrete MPCTensors and the public torch tensors its ops read (never
closed over: a repeated scope reads them anew), run by one
``parallel.CompiledParties`` kept per tape structure (the nodes, their
arguments and configs, and which outputs are still referenced). On a CUDA
session that is one capture (raising where the capture fails) and a replay
a flush; on a CPU session it runs eagerly. Each flush draws under a seed
of its own, which never repeats within a session and is never the
session's own (curl_tpu/__init__.py:135-140), and each flush counts the
program's rounds and bytes in the session's CommStats. Where a tuple cache
is attached or the provider records requests, the flush runs the nodes
eagerly in recorded order under the session's keys, popping (or
recording) what the ops run eagerly would.

An op that cannot be shape-evaluated so (it reads values on the host, or
returns something other than MPCTensors) is a *fallback*: the tape is
flushed and the op runs eagerly, and the tape counts it.
"""

from __future__ import annotations

import collections
import contextlib
import weakref

import numpy as np
import torch

FALLBACK = object()

# the active Tape; None outside a scope and while an op runs
_tape = None

# op evaluations on the meta device, by the op and its inputs' kinds
_MEMO = {}
MAX_MEMO = 1 << 16
# the programs flushes ran, by tape structure (each holds a captured graph
# on a card)
_PROGRAMS = collections.OrderedDict()
MAX_PROGRAMS = 4

_M64 = (1 << 64) - 1
_FLUSH_TAG = 0x1A2BF105  # the flush seeds' derivation tag


class Session:
    """The flush seeds of a session: derived from its seed and a count
    that ``reset`` (called by ``init``) restarts."""

    seed = 0
    flushes = 0


def reset(seed: int = 0):
    """A new session at ``seed``: the flush count restarts and the programs
    of the last session (and their graphs) are dropped."""
    Session.seed = int(seed) & _M64
    Session.flushes = 0
    _PROGRAMS.clear()


def flush_seed() -> int:
    """The next flush's seed: never the session's own, never one given
    before in the session."""
    from .random import _splitmix64

    while True:
        Session.flushes += 1
        seed = _splitmix64(_splitmix64(Session.seed ^ _FLUSH_TAG) ^ Session.flushes)
        if seed != Session.seed:
            return seed


class Pending:
    """A pending MPCTensor's record: its tape, node and output index, and
    the op's abstract output (an inner tensor on the meta device)."""

    __slots__ = ("tape", "node", "leaf", "abstract")

    def __init__(self, tape, node, leaf, abstract):
        self.tape, self.node, self.leaf, self.abstract = tape, node, leaf, abstract


class _Node:
    __slots__ = ("fn", "spec", "n_out", "snap", "key")

    def __init__(self, fn, spec, n_out, snap, key):
        self.fn, self.spec, self.n_out, self.snap, self.key = fn, spec, n_out, snap, key


# ---------------------------------------------------------------------------
# arguments: what a node reads, and its keys
# ---------------------------------------------------------------------------

_SCALARS = (bool, int, float, complex, str, bytes, type(None), type(Ellipsis), slice,
            torch.dtype, torch.device)


def _static_key(v):
    """A hashable key of a static argument: equal for values an op treats
    alike (the type is part of it: 1 and 1.0 differ)."""
    if isinstance(v, _SCALARS):
        return (type(v), v)
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, np.generic):
        return (type(v), v.item())
    try:
        hash(v)
    except TypeError:
        return ("id", id(v))  # the node keeps v alive
    return (type(v), v)


def _mpc_key(t):
    """What an op's abstract output may depend on, of an MPCTensor input
    (the memo's key also holds the world size)."""
    inner = t._peek()
    return ("mpc", type(inner), t.ptype, tuple(inner.shape), inner.encoder.precision_bits,
            getattr(inner, "transposed", None))


class _Args:
    """The walk of one op's arguments: the spec that rebuilds them at the
    flush, the structure key and the evaluation key."""

    def __init__(self, tape):
        self.tape = tape

    def walk(self, x):
        """(spec, key, eval key) of ``x``."""
        from .mpc.mpc import MPCTensor

        if isinstance(x, MPCTensor):
            rec = x._lazy
            if x._inner is None and rec.tape is not self.tape:
                rec.tape.flush()  # a cross-tape dependency: settle the other tape first
                rec = None
            if x._inner is None:
                ref = ("o", rec.node, rec.leaf)
                return ref, ref, _mpc_key(x)
            ref = ("r", self.tape._root(x._inner, x.ptype))
            return ref, ref, _mpc_key(x)
        if isinstance(x, torch.Tensor):
            from . import comm

            device = comm.get_device()
            if x.device != device:
                x = x.to(device)  # as the op would take it, outside the program
            ref = ("p", self.tape._public(x))
            return ref, ref, ("pub", tuple(x.shape), x.dtype)
        if isinstance(x, (list, tuple)):
            parts = [self.walk(v) for v in x]
            kind = "list" if isinstance(x, list) else "tuple"
            return ((kind, tuple(p[0] for p in parts)), (kind, tuple(p[1] for p in parts)),
                    (kind, tuple(p[2] for p in parts)))
        if isinstance(x, dict):
            parts = [self.walk(v) for v in x.values()]
            names = tuple(x)
            return (("dict", names, tuple(p[0] for p in parts)),
                    ("dict", names, tuple(p[1] for p in parts)),
                    ("dict", names, tuple(p[2] for p in parts)))
        k = _static_key(x)
        return ("s", x), k, k


def _build(spec, roots, publics, outs):
    """The argument of ``spec`` over the flush's roots, publics and the
    outputs of the nodes before it."""
    kind = spec[0]
    if kind == "r":
        return roots[spec[1]]
    if kind == "o":
        return outs[spec[1]][spec[2]]
    if kind == "p":
        return publics[spec[1]]
    if kind == "s":
        return spec[1]
    if kind in ("list", "tuple"):
        items = [_build(v, roots, publics, outs) for v in spec[1]]
        return items if kind == "list" else tuple(items)
    return {k: _build(v, roots, publics, outs) for k, v in zip(spec[1], spec[2])}


def _flat_out(out, leaves: list):
    """The output tree of ``out`` with its MPCTensors appended to ``leaves``
    (None where a leaf is something else)."""
    from .mpc.mpc import MPCTensor

    if isinstance(out, MPCTensor):
        leaves.append(out)
        return len(leaves) - 1
    if isinstance(out, (list, tuple)):
        return (type(out), tuple(_flat_out(v, leaves) for v in out))
    return None


def _tree_ok(tree) -> bool:
    if tree is None:
        return False
    if isinstance(tree, int):
        return True
    return all(_tree_ok(v) for v in tree[1])


def _unflat(tree, leaves):
    if isinstance(tree, int):
        return leaves[tree]
    kind, items = tree
    return kind(_unflat(v, leaves) for v in items)


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def _meta_inner(inner):
    """A copy of an inner share tensor whose tensors lie on the meta device."""
    from .mpc.primitives.arithmetic import ArithmeticSharedTensor
    from .mpc.primitives.binary import BinarySharedTensor
    from .mpc.primitives.compressed import SeedCompressedArithmetic

    if type(inner) is SeedCompressedArithmetic:
        return SeedCompressedArithmetic(_meta(inner.share0), inner.key, inner.encoder,
                                        inner.transposed)
    if type(inner) in (ArithmeticSharedTensor, BinarySharedTensor):
        return type(inner)(_meta(inner.share), inner.encoder)
    raise TypeError(f"no abstract form of a {type(inner).__name__}")


@contextlib.contextmanager
def _on_meta():
    """Run an op on the meta device without leaving a trace: the device,
    the draw counters, CommStats, launch counts, the provider's requests
    and its cache are as they were after it."""
    from . import comm
    from . import random as rng
    from .autograd import no_grad
    from .mpc import get_default_provider
    from .parallel.runner import _uncounted

    provider = get_default_provider()
    device, counter, constructions = comm.get_device(), rng.counter(), rng._constructions
    tracing, n_requests = provider.tracing, len(provider.requests)
    comm.set_device("meta")
    provider.tracing = False
    try:
        with _uncounted(), provider.serving(None), no_grad():
            yield
    finally:
        comm.set_device(device)
        rng.set_counter(counter)
        rng._constructions = constructions
        provider.tracing = tracing
        del provider.requests[n_requests:]


def _evaluate(fn, spec, tape):
    """The op's abstract output (tree, leaves) on the meta device, or
    FALLBACK."""
    from .mpc.mpc import MPCTensor

    roots = [MPCTensor(_meta_inner(inner), ptype) for inner, ptype in tape._roots]
    publics = [_meta(t) for t in tape._publics]
    outs = [[MPCTensor(_meta_inner(inner), ptype) for inner, ptype in node_out]
            for node_out in tape._abstracts]
    args, kwargs = _build(spec, roots, publics, outs)
    with _on_meta():
        out = fn(*args, **kwargs)
    leaves = []
    tree = _flat_out(out, leaves)
    if not leaves or not _tree_ok(tree):
        return FALLBACK
    return tree, [(leaf._tensor, leaf.ptype) for leaf in leaves]


# ---------------------------------------------------------------------------
# the tape
# ---------------------------------------------------------------------------

class Tape:
    """The ops recorded in one scope since its last flush.

    ``nodes`` the recorded ops, ``pending`` the pending tensors handed out
    that are still referenced; ``flushes`` and ``fallbacks`` count this
    scope's flushes and the ops that fell back to flush-then-eager;
    ``program`` and ``seed`` are the runner and the seed of its latest
    flush."""

    def __init__(self):
        self.flushes = 0
        self.fallbacks = 0
        # the CompiledParties of the latest flush and its seed (None: eager)
        self.program = self.seed = None
        self._clear()

    def _clear(self):
        self.nodes = []
        self._pending = []
        self._roots, self._root_ids = [], {}
        self._publics, self._public_ids = [], {}
        self._abstracts = []

    @property
    def pending(self) -> list:
        """The pending tensors handed out since the last flush that are
        still referenced."""
        return [t for t in (r() for r in self._pending)
                if t is not None and t._inner is None and t._lazy.tape is self]

    def _root(self, inner, ptype) -> int:
        key = (id(inner), ptype)
        idx = self._root_ids.get(key)
        if idx is None:
            idx = self._root_ids[key] = len(self._roots)
            self._roots.append((inner, ptype))
        return idx

    def _public(self, t: torch.Tensor) -> int:
        idx = self._public_ids.get(id(t))
        if idx is None:
            idx = self._public_ids[id(t)] = len(self._publics)
            self._publics.append(t)
        return idx

    def hold(self, t):
        """Fill ``t`` too at the flush (``MPCTensor._assign``)."""
        self._pending.append(weakref.ref(t))

    # -- record ------------------------------------------------------------
    def record(self, fn, args, kwargs):
        """``fn(*args, **kwargs)`` recorded: its pending outputs; an op that
        cannot be evaluated abstractly runs eagerly after a flush."""
        global _tape
        from . import comm, config
        from .mpc.mpc import MPCTensor

        spec, key, ekey = _Args(self).walk((args, kwargs))
        snap = _snapshot_id(config)
        memo_key = (fn, ekey, snap, comm.get_world_size())
        result = _MEMO.get(memo_key)
        if result is None:
            saved, _tape = _tape, None
            try:
                result = _evaluate(fn, spec, self)
            except Exception:  # noqa: BLE001  (any failure of the abstract run: fall back)
                result = FALLBACK
            finally:
                _tape = saved
            if len(_MEMO) >= MAX_MEMO:
                _MEMO.clear()
            _MEMO[memo_key] = result
        if result is FALLBACK:
            return self._fallback(fn, args, kwargs)
        tree, abstracts = result
        idx = len(self.nodes)
        self.nodes.append(_Node(fn, spec, len(abstracts), snap, (fn, key, snap)))
        self._abstracts.append(abstracts)
        outs = []
        for leaf, (inner, ptype) in enumerate(abstracts):
            t = MPCTensor._pending(Pending(self, idx, leaf, inner), ptype)
            self._pending.append(weakref.ref(t))
            outs.append(t)
        return _unflat(tree, outs)

    def _fallback(self, fn, args, kwargs):
        global _tape
        self.fallbacks += 1
        self.flush()
        saved, _tape = _tape, None
        try:
            return fn(*args, **kwargs)
        finally:
            _tape = saved

    # -- flush ---------------------------------------------------------------
    def flush(self):
        """Run the recorded nodes as one program and fill every pending
        tensor still referenced."""
        global _tape
        if not self.nodes:
            return
        nodes, roots, publics = self.nodes, self._roots, self._publics
        held = [(t, t._lazy) for t in self.pending]
        self._clear()
        wanted = sorted({(rec.node, rec.leaf) for _, rec in held})
        saved, _tape = _tape, None
        try:
            results, self.program, self.seed = _run(nodes, roots, publics, wanted)
        finally:
            _tape = saved
        self.flushes += 1
        at = {w: i for i, w in enumerate(wanted)}
        for t, rec in held:
            out = results[at[(rec.node, rec.leaf)]]
            t._tensor = out._tensor
            t.ptype = out.ptype


def _snapshot_id(config) -> int:
    """A small int naming the current config (``cfg.snapshot()``; equal
    configs, equal ids), looked up again only after a change."""
    version = config._version[0]
    if _SNAP["version"] != version:
        snap = config.cfg.snapshot()
        ids = _SNAP["ids"]
        if snap not in ids:
            ids[snap] = len(ids)
            _SNAP["configs"][ids[snap]] = config.cfg.to_dict()
        _SNAP["version"], _SNAP["id"] = version, ids[snap]
    return _SNAP["id"]


# config ids: by snapshot, and each id's config as a dict
_SNAP = {"version": None, "id": None, "ids": {}, "configs": {}}


def _program_fn(nodes, wanted):
    """The function a flush runs: every node in order, each under the
    config it was recorded under, off the autograd tape."""
    from . import config
    from .autograd import no_grad
    from .mpc.mpc import MPCTensor

    def run(roots, publics):
        outs = []
        current = _snapshot_id(config)
        with no_grad():
            for node in nodes:
                args, kwargs = _build(node.spec, roots, publics, outs)
                if node.snap == current:
                    out = node.fn(*args, **kwargs)
                else:
                    with config.cfg.restored(_SNAP["configs"][node.snap]):
                        out = node.fn(*args, **kwargs)
                leaves = []
                _flat_out(out, leaves)
                if len(leaves) != node.n_out or not all(isinstance(v, MPCTensor) for v in leaves):
                    raise RuntimeError(f"lazy flush: {node.fn.__name__} returned other outputs "
                                       "than it did when recorded")
                outs.append(leaves)
        return [outs[n][leaf] for n, leaf in wanted]

    return run


def _run(nodes, roots, publics, wanted):
    """The wanted outputs of one flush."""
    from . import comm
    from .mpc import get_default_provider
    from .mpc.mpc import MPCTensor
    from .parallel.runner import CompiledParties

    root_mpcs = [MPCTensor(inner, ptype) for inner, ptype in roots]
    fn = _program_fn(nodes, wanted)
    provider = get_default_provider()
    if provider.current_cache() is not None or provider.tracing:
        # served from the host cache (or recording requests): the ops as
        # they would run eagerly, in order, under the session's keys
        return fn(root_mpcs, publics), None, None
    world_size = comm.get_world_size()
    structure = (tuple(node.key for node in nodes), tuple(wanted), world_size)
    program = _PROGRAMS.get(structure)
    if program is None:
        program = CompiledParties(fn, world_size, count_each_call=True)
        _PROGRAMS[structure] = program
        while len(_PROGRAMS) > MAX_PROGRAMS:
            _PROGRAMS.popitem(last=False)
    else:
        _PROGRAMS.move_to_end(structure)
    seed = flush_seed()
    return program(seed, root_mpcs, list(publics)), program, seed


def call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, recorded on the active tape inside a scope
    (``fn`` takes and returns MPCTensors; a module-level function, so that
    a repeated scope finds its evaluation and its program)."""
    tape = _tape
    if tape is None:
        return fn(*args, **kwargs)
    return tape.record(fn, args, kwargs)


@contextlib.contextmanager
def lazy():
    """Record the MPCTensor ops of the block and run them as one program
    (see the module docstring); yields the Tape. Scopes nest: an inner
    scope's tape flushes at its exit, and an op reading another tape's
    pending tensor flushes that tape first."""
    from . import comm

    comm.get_device()  # raises before init
    global _tape
    prev = _tape
    tape = Tape()
    _tape = tape
    try:
        yield tape
    finally:
        _tape = prev
        tape.flush()
