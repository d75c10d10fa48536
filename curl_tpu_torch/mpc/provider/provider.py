"""Tuple-provider base: request tracing and the offline tuple cache.

Counterpart of ``curl_tpu/mpc/provider/provider.py`` (the reference's
``curl/mpc/provider/provider.py:47-157``). A subclass's methods named in
``TRACEABLE_FUNCTIONS`` are wrapped when the class is made
(``__init_subclass__``), so every call goes through ``_serve_or``:

  * recording (``trace(True)``): the call's (function, shapes, kwargs) is
    appended to ``requests`` and the tuple is still generated inline, so a
    recording run computes valid results;
  * serving: a cache bound to a program (``serving(cache)``, the online
    program of ``compile_parties_cached``), or, for eager ops outside any
    program, the host cache attached by ``fill_cache``/``attach_cache``,
    hands out its entries in order: request N of the serving run takes
    entry N of the fill. A serving run never generates a tuple; a request
    past the cache's end raises "exhausted".

``fill_cache_entries`` generates every recorded request in order (the
offline phase). Entries are the port's own objects: ArithmeticSharedTensor,
BinarySharedTensor and ``(P, ...)`` share tensors, in tuples and lists, and
the dealer plaintexts a method returns without a party axis
(``DEALER_PLAINTEXTS``). Requests are saved as JSON and caches as ``.npz``
(``allow_pickle=False``) with a JSON description of the entries beside the
arrays: no file the port reads or writes holds a pickle.
"""

from __future__ import annotations

import contextlib
import json
import numbers
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

# the JAX package's list (provider.py:28-37)
TRACEABLE_FUNCTIONS = [
    "generate_additive_triple",
    "square",
    "generate_binary_triple",
    "wrap_rng",
    "B2A_rng",
    "generate_one_hot",
    "generate_lut_masks",
    "egk_trunc_pr_rng",
]

# the items of a method's tuple that are dealer plaintexts: no party axis,
# party 0's alone (the trusted first party's); party 0's file holds them
DEALER_PLAINTEXTS = {"generate_lut_masks": (0,)}

REQUESTS_FORMAT = "curl_tpu_torch tuple requests"
CACHE_FORMAT = "curl_tpu_torch tuple cache"


@dataclass
class TupleRequest:
    func: str
    args: tuple
    kwargs: tuple


@dataclass
class TupleCache:
    """The offline tuple stream, served in order. ``funcs`` names each
    entry's provider method (where the cache came from a fill); a cache
    whose tensors a later fill rewrote in place is ``overwritten``."""

    entries: List[Any] = field(default_factory=list)
    cursor: int = 0
    funcs: Optional[List[str]] = None
    overwritten: bool = False
    # the online program's flattening of ``entries``, made once a cache
    _flat: Any = field(default=None, repr=False, compare=False)

    def pop(self):
        if self.cursor >= len(self.entries):
            raise RuntimeError(
                "tuple cache exhausted — the serving run requests more tuples "
                f"than the {len(self.entries)} prefilled"
            )
        out = self.entries[self.cursor]
        self.cursor += 1
        return out

    def reset(self):
        self.cursor = 0


def _plain_arg(v):
    """A request argument as JSON keeps it: shapes as tuples of ints."""
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, (tuple, list, torch.Size)):
        return tuple(_plain_arg(u) for u in v)
    raise TypeError(f"a tuple request cannot record a {type(v).__name__} argument")


def _make_traced(fname, fn):
    def wrapper(self, *args, **kwargs):
        return self._serve_or(fname, lambda: fn(self, *args, **kwargs), args, kwargs)

    wrapper.__name__ = fname
    wrapper.__doc__ = fn.__doc__
    wrapper.__wrapped__ = fn
    return wrapper


class TupleProvider:
    """Base provider with the trace/cache interposition (the reference's
    ``__getattribute__`` interposition, provider.py:114-157)."""

    NAME: str = "base"

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for fname in TRACEABLE_FUNCTIONS:
            fn = cls.__dict__.get(fname)
            if fn is not None and not hasattr(fn, "__wrapped__"):
                setattr(cls, fname, _make_traced(fname, fn))

    def __init__(self):
        self.tracing: bool = False
        self.requests: List[TupleRequest] = []
        self._active_cache: Optional[TupleCache] = None
        self._serving_cache: Optional[TupleCache] = None
        self._in_program = False

    # -- trace / cache management (reference provider.py:28-157) ---------
    def trace(self, tracing: bool = True):
        self.tracing = tracing

    def trace_once(self):
        self.trace(len(self.requests) == 0)

    def record_request(self, func, args, kwargs):
        self.requests.append(TupleRequest(
            func, _plain_arg(args), tuple(sorted((k, _plain_arg(v)) for k, v in kwargs.items()))))

    def attach_cache(self, cache: Optional[TupleCache]):
        """The host cache: eager ops outside any program pop its entries
        from its cursor on (reset here)."""
        self._active_cache = cache
        if cache is not None:
            cache.reset()

    def attach_serving_cache(self, cache: Optional[TupleCache]):
        """The cache the running program's calls pop from."""
        self._serving_cache = cache

    @contextlib.contextmanager
    def serving(self, cache: Optional[TupleCache]):
        """Bind what a program's provider calls draw on: ``cache``'s entries
        in order, or (None) fresh tuples generated inline; the host cache is
        not served inside, as the JAX package serves it only to eager ops."""
        saved = self._serving_cache, self._in_program
        self._serving_cache, self._in_program = cache, True
        try:
            yield cache
        finally:
            self._serving_cache, self._in_program = saved

    def current_cache(self) -> Optional[TupleCache]:
        """The cache a provider call made now would be served from."""
        if self._serving_cache is not None or self._in_program:
            return self._serving_cache
        return self._active_cache

    def _serve_or(self, func_name, generate_fn, args, kwargs):
        cache = self.current_cache()
        if cache is not None:
            return cache.pop()
        if self.tracing:
            self.record_request(func_name, args, kwargs)
        return generate_fn()

    def fill_cache_entries(self, requests=None):
        """Generate ``requests`` (the recorded ones by default) in order,
        under the keys and from the draw counter bound now; returns the
        list of tuples."""
        entries = []
        was_tracing = self.tracing
        self.tracing = False
        try:
            with self.serving(None):
                for req in self.requests if requests is None else requests:
                    entries.append(getattr(self, req.func)(*req.args, **dict(req.kwargs)))
        finally:
            self.tracing = was_tracing
        return entries

    # -- requests on disk: JSON ------------------------------------------
    def save_requests(self, path):
        save_requests(self.requests, path)

    def load_requests(self, path):
        self.requests = load_requests(path)

    # -- the cache on disk: .npz with a JSON description ------------------
    def save_cache(self, path):
        """Write the host cache (the offline phase's checkpoint)."""
        if self._active_cache is None:
            raise RuntimeError("no active cache to save")
        save_cache(self._active_cache, path)

    def load_cache(self, path) -> TupleCache:
        cache = load_cache(path)
        self.attach_cache(cache)
        return cache


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def _json_value(v):
    return [_json_value(u) for u in v] if isinstance(v, tuple) else v


def save_requests(requests, path):
    doc = {"format": REQUESTS_FORMAT, "version": 1,
           "requests": [{"func": r.func, "args": _json_value(r.args),
                         "kwargs": {k: _json_value(v) for k, v in r.kwargs}} for r in requests]}
    with open(path, "w") as f:
        json.dump(doc, f)


def _checked_arg(v, where):
    if isinstance(v, list):
        return tuple(_checked_arg(u, where) for u in v)
    if isinstance(v, (str, bool, int)) or v is None:
        return v
    raise ValueError(f"{where}: a request argument must be an integer, a string or a shape, "
                     f"not {type(v).__name__}")


def load_requests(path) -> List[TupleRequest]:
    """Read a request file; raises ValueError, having executed nothing,
    where it does not parse or names a function outside
    ``TRACEABLE_FUNCTIONS``."""
    try:
        with open(path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: not a tuple request file ({e})") from None
    if not isinstance(doc, dict) or doc.get("format") != REQUESTS_FORMAT \
            or not isinstance(doc.get("requests"), list):
        raise ValueError(f"{path}: not a tuple request file")
    out = []
    for i, r in enumerate(doc["requests"]):
        where = f"{path}: request {i}"
        if not isinstance(r, dict) or set(r) != {"func", "args", "kwargs"} \
                or not isinstance(r["args"], list) or not isinstance(r["kwargs"], dict):
            raise ValueError(f"{where}: malformed")
        if r["func"] not in TRACEABLE_FUNCTIONS:
            raise ValueError(f"{where}: {r['func']!r} is not a traceable provider function")
        out.append(TupleRequest(r["func"], _checked_arg(r["args"], where), tuple(sorted(
            (str(k), _checked_arg(v, where)) for k, v in r["kwargs"].items()))))
    return out


def _describe(x, leaves: list, plain: bool = False):
    from ..primitives.arithmetic import ArithmeticSharedTensor
    from ..primitives.binary import BinarySharedTensor

    if isinstance(x, (list, tuple)):
        return {type(x).__name__: [_describe(v, leaves) for v in x]}
    if type(x) in (ArithmeticSharedTensor, BinarySharedTensor):
        leaves.append(x.share)
        kind = "arith" if isinstance(x, ArithmeticSharedTensor) else "binary"
        return {kind: x.encoder.precision_bits, "leaf": len(leaves) - 1}
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"a tuple cache cannot hold a {type(x).__name__}")
    leaves.append(x)
    return {"plain" if plain else "shares": len(leaves) - 1}


def describe(entries, funcs=None):
    """(a JSON-able description of ``entries``, their tensors in order):
    {"arith"|"binary": precision bits, "leaf": i}, {"shares": i} for a
    tensor with a party axis, {"plain": i} for a dealer plaintext, and
    {"tuple"|"list": [...]}. (Module-level recursion, not a closure: a
    closure's reference cycle would hold a fill's tensors until the next
    garbage collection.)"""
    leaves, out = [], []
    for i, entry in enumerate(entries):
        items = DEALER_PLAINTEXTS.get(funcs[i], ()) if funcs else ()
        if isinstance(entry, tuple) and items:
            out.append({"tuple": [_describe(v, leaves, j in items) for j, v in enumerate(entry)]})
        else:
            out.append(_describe(entry, leaves))
    return out, leaves


def _items(d) -> list:
    return d["tuple"] if "tuple" in d else d["list"]


def _rebuild(d, leaves):
    from ...encoder import FixedPointEncoder
    from ..primitives.arithmetic import ArithmeticSharedTensor
    from ..primitives.binary import BinarySharedTensor

    if not isinstance(d, dict):
        raise ValueError("malformed cache description")
    if "tuple" in d or "list" in d:
        items = [_rebuild(v, leaves) for v in _items(d)]
        return tuple(items) if "tuple" in d else items
    for kind, cls in (("arith", ArithmeticSharedTensor), ("binary", BinarySharedTensor)):
        if kind in d:
            return cls(leaves[d["leaf"]], FixedPointEncoder(int(d[kind])))
    if "shares" in d or "plain" in d:
        return leaves[d.get("shares", d.get("plain"))]
    raise ValueError("malformed cache description")


def rebuild(desc, leaves):
    """The entries ``describe`` described, over ``leaves``."""
    try:
        return [_rebuild(d, leaves) for d in desc]
    except (KeyError, IndexError, TypeError, ValueError) as e:
        raise ValueError(f"malformed cache description ({e})") from None


def _leaf_kinds(d, kinds: dict):
    if "tuple" in d or "list" in d:
        for v in _items(d):
            _leaf_kinds(v, kinds)
    elif "leaf" in d:
        kinds[d["leaf"]] = "shares"
    else:
        kind = "shares" if "shares" in d else "plain"
        kinds[d[kind]] = kind


def leaf_kinds(desc) -> dict:
    """{leaf index: "shares" or "plain"} over a description (the shares of
    an arith or binary entry count as "shares")."""
    kinds = {}
    for d in desc:
        _leaf_kinds(d, kinds)
    return kinds


def _header(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)


def write_npz(path, meta: dict, arrays: dict):
    """``meta`` as JSON bytes beside ``{index: tensor}`` as ``leaf{index}``."""
    np.savez(path, __meta__=_header(meta),
             **{f"leaf{i}": t.cpu().numpy() for i, t in arrays.items()})


def read_npz(path, fmt):
    """(meta, {leaf index: array}) of a file ``write_npz`` wrote; raises
    ValueError on anything else. Nothing is unpickled."""
    try:
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
            arrays = {int(k[4:]): data[k] for k in data.files if k.startswith("leaf")}
    except (KeyError, ValueError, OSError, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: not a tuple cache file ({e})") from None
    if not isinstance(meta, dict) or meta.get("format") != fmt \
            or any(a.dtype != np.int64 for a in arrays.values()):
        raise ValueError(f"{path}: not a tuple cache file")
    return meta, arrays


def save_cache(cache: TupleCache, path):
    desc, leaves = describe(cache.entries, cache.funcs)
    write_npz(path, {"format": CACHE_FORMAT, "version": 1, "entries": desc, "funcs": cache.funcs},
              dict(enumerate(leaves)))


def load_cache(path) -> TupleCache:
    """A cache ``save_cache`` wrote, on the session's device."""
    from ... import comm

    path = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
    meta, arrays = read_npz(path, CACHE_FORMAT)
    if sorted(arrays) != list(range(len(arrays))):
        raise ValueError(f"{path}: not a tuple cache file")
    leaves = [torch.from_numpy(arrays[i]).to(comm.get_device()) for i in range(len(arrays))]
    return TupleCache(rebuild(meta["entries"], leaves), funcs=meta.get("funcs"))


def get_provider(name: str) -> TupleProvider:
    """A new provider of ``mpc.provider``'s name: TFP, TTP or HE
    (curl_tpu/mpc/provider/__init__.py)."""
    from .homomorphic_provider import HomomorphicProvider
    from .tfp_provider import TrustedFirstParty
    from .ttp_provider import TrustedThirdParty

    providers = {"TFP": TrustedFirstParty, "TTP": TrustedThirdParty, "HE": HomomorphicProvider}
    if name not in providers:
        raise ValueError(f"mpc.provider is one of {sorted(providers)}, not {name!r}")
    return providers[name]()
