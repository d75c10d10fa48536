"""Correlated random streams for the MPC parties, from one Philox kernel.

Counterpart of ``curl_tpu/random.py``. Every stream is a 64-bit Philox seed:

  ring[i]   shared by parties i and i + 1: party p's "next" stream is ring[p]
            and its "prev" stream ring[p - 1], so next[p] == prev[p + 1] and
            PRZS telescopes to zero over the parties;
  local[p]  private to party p;
  ttp[p]    shared by party p and the trusted third party (the TTP
            provider's dealer): party p >= 1 draws its tuple shares from
            it, and the dealer gives party 0 the rest;
  global    shared by all parties (public randomness);
  dealer    the TFP dealer's stream for tuple plaintexts;
  fused     the dealer's stream for the randomness the fused protocol
            kernels draw in-kernel (``kernels/fused_mul.py``,
            ``kernels/max_step.py``), derived from the dealer seed;
  param     the root of the per-tensor keys of seed-compressed weights
            (``compressed_master``), never a stream seed itself.

A draw is (stream seed, draw counter, element index) -> 64 bits: the counter
advances once per draw and restarts in ``init`` (``reset_count``), so a
seeded session replays the same randomness whatever ran before it.

The stream seeds live in one session key table (``kernels/keys.KeyTable``):
``next``, ``prev`` and ``local`` for up to ``MAX_PARTIES`` parties, then
``global``, ``dealer`` and ``fused``, then ``ttp`` for up to ``MAX_PARTIES``
parties, on the host and on each device that a
kernel has read it from. ``set_keys`` writes it in place and never
reallocates it, and every segment and fused call names a stream by its
slot (``stream_ref``, ``fused_key``), not by its value: a launch captured
in a CUDA graph reads the keys the table holds at replay, as the JAX
package's jitted program takes its keys as an argument. The ``param`` root
is no stream seed and stays on the host; the per-tensor keys of
seed-compressed weights are literals fixed when the model is built. Dealer
and global draws carry no party axis (computed once); per-party draws come
back as (P, ...). On a CUDA device the draws and shares of one call are
segments (``kernels/philox.Segment``) of one grouped launch of the Philox
kernel (``launch``): the TFP dealer reserves a call's draw counters in order
(``reserve_counts``), then hands its segments over together. On the CPU the
kernel's plain version runs.

The streams will never match the JAX package's threefry or the TPU's
hardware PRNG: compare decoded values and invariants, never shares.
"""

from __future__ import annotations

import math
import threading

import torch

from . import comm
from .kernels.keys import KeyTable
from .kernels.philox import MAX_ROWS, MAX_SEGMENTS, Segment, philox_group

_M64 = (1 << 64) - 1

_counter = 0
_constructions = 0
_counter_lock = threading.Lock()
_keys = None

# the session key table: first slot of each stream (per-party streams take
# MAX_PARTIES slots, one a party; the shared ones one)
MAX_PARTIES = MAX_ROWS
SLOTS = {"next": 0, "prev": MAX_PARTIES, "local": 2 * MAX_PARTIES,
         "global": 3 * MAX_PARTIES, "dealer": 3 * MAX_PARTIES + 1,
         "fused": 3 * MAX_PARTIES + 2, "ttp": 3 * MAX_PARTIES + 3}
TABLE = KeyTable(4 * MAX_PARTIES + 3)


def _next_count() -> int:
    global _counter
    with _counter_lock:
        c = _counter
        _counter += 1
        return c


def reserve_counts(k: int) -> list:
    """k consecutive draw counters, as k calls of ``_next_count`` give them."""
    global _counter
    with _counter_lock:
        c = _counter
        _counter += k
        return list(range(c, c + k))


def counter() -> int:
    """The next draw counter."""
    return _counter


def set_counter(c: int):
    """Continue drawing from counter ``c`` (the compiled runner replays a
    captured forward's counters)."""
    global _counter
    with _counter_lock:
        _counter = int(c)


def reset_count():
    """Restart the draw counter and the counter of compressed constructions
    (called by ``curl_tpu_torch.init``)."""
    global _counter, _constructions
    with _counter_lock:
        _counter = 0
        _constructions = 0


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def make_party_keys(seed: int, world_size: int) -> dict:
    """Stream seeds with the ring-correlation invariant next[p] == prev[p+1]."""
    def derive(tag: int, i: int = 0) -> int:
        return _splitmix64(_splitmix64(_splitmix64(seed & _M64) ^ tag) ^ i)

    ring = [derive(1, i) for i in range(world_size)]
    dealer = derive(4)
    return {
        "next": ring,
        "prev": [ring[(p - 1) % world_size] for p in range(world_size)],
        "local": [derive(2, i) for i in range(world_size)],
        "ttp": [derive(6, i) for i in range(world_size)],
        "global": [derive(3)],
        "dealer": [dealer],
        "fused": [_splitmix64(dealer ^ 0x46555345445F4B31)],
        "param": [derive(5)],
    }


def set_keys(keys: dict):
    """Make ``keys`` (``make_party_keys``'s) the session's streams: the host
    dict, and the key table written in place, on the host and on each
    device copy in stream order."""
    global _keys
    P = len(keys["next"])
    if not 1 <= P <= MAX_PARTIES:
        raise ValueError(f"the key table holds 1 to {MAX_PARTIES} parties, not {P}")
    for name, slot in SLOTS.items():
        TABLE.write(keys[name], slot)
    _keys = keys


def clear_keys():
    """Drop the session's streams (``uninit``): draws raise until the next
    ``set_keys``."""
    global _keys
    _keys = None


def session_keys():
    """The session's key dict, or None before ``init``."""
    return _keys


def current_keys() -> dict:
    if _keys is None:
        raise RuntimeError("curl_tpu_torch.init() must be called first")
    return _keys


# Per-tensor keys of seed-compressed weights (``mpc/primitives/compressed.py``).
# The tags are the JAX package's ``fold_in`` tags: each construction folds one
# of them into a fresh master key, and each tensor or chunk folds its index
# into the master (curl_tpu/nn/module.py:134-152 and :339-374,
# curl_tpu/models/gpt.py:39 and :91).
SEED_COMPRESS = 0x5EEDC0   # Module.encrypt(seed_compress=True)
HEAD = 0x10EAD             # the LM head's ChunkedLinear (the JAX ChunkedLMHead)
EMBED = 0xE4BED            # ChunkedEmbedding
CHUNKED_LINEAR = 0xC4C4    # ChunkedLinear, plus its chunk axis


def fold_in(key: int, data: int) -> int:
    """A 64-bit key derived from ``key`` and ``data`` (jax.random.fold_in's
    role)."""
    return _splitmix64(key ^ _splitmix64(data & _M64))


def compressed_master(tag: int) -> int:
    """The master key of one compressed construction: the session's ``param``
    root, a construction counter that ``init`` restarts, and ``tag``. The
    root is derived under a tag of its own, so no key drawn from it is a
    session stream seed but by a 2^-64 chance (which the tests check)."""
    global _constructions
    with _counter_lock:
        c = _constructions
        _constructions += 1
    return fold_in(fold_in(current_keys()["param"][0], c), tag)


# party-invariant streams: one row, no party axis
_SHARED = ("global", "dealer", "fused")


def stream_ref(generator: str):
    """The slots of ``generator``'s stream seeds in the session key table:
    one row for a shared stream, one a party for a per-party one."""
    rows = 1 if generator in _SHARED else len(current_keys()[generator])
    return TABLE.ref(SLOTS[generator], rows)


def fused_key():
    """The slot of the ``fused`` stream, the key of the fused protocol
    kernels (``kernels/fused_mul.py``, ``kernels/max_step.py``)."""
    current_keys()
    return TABLE.ref(SLOTS["fused"])


def dealer_stream() -> str:
    """Stream for tuple plaintexts (Beaver a/b, square r, LUT r, EGK
    randomness): drawn once, without a party axis, like the JAX package's
    party-invariant dealer stream under the simulated-party runtime."""
    return "dealer"


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def _flat(value: torch.Tensor, per_party: bool) -> torch.Tensor:
    P = len(current_keys()["next"])
    return value.reshape((P, -1) if per_party else (-1,)).contiguous()


def segment_draw(shape, bitlength: int, generator: str, counter: int) -> Segment:
    """Uniform k-bit values in [0, 2^bitlength) of ``generator``'s streams."""
    return Segment("draw", stream_ref(generator), counter, _numel(tuple(shape)),
                   kbits=min(bitlength, 64))


def segment_zero(shape, counter: int, how: str = "add", bits: int = 64) -> Segment:
    """A sharing of zero over the ring streams: additive (PRZS) or XOR of
    ``bits``-bit streams."""
    return Segment("zero", stream_ref("next"), counter, _numel(tuple(shape)), how=how,
                   kbits=bits)


def segment_share(value: torch.Tensor, counter: int, src: int = 0, per_party: bool = False,
                  how: str = "add") -> Segment:
    """A dealer sharing of ``value``: a sharing of zero plus (or XOR)
    ``value`` on party ``src``; ``per_party``: value is (P,) + S and only
    row src enters."""
    flat = _flat(value, per_party)
    return Segment("plain_lane" if per_party else "plain", stream_ref("next"), counter,
                   flat.shape[-1], how=how, src=src, plain=flat)


def segment_fresh(shape, bitlength: int, draw_counter: int, counter: int, how: str = "add",
                  emit: bool = False) -> Segment:
    """A dealer draw of ``bitlength`` bits at ``draw_counter``, shared on
    party 0 in the same pass (``emit``: returned beside the shares)."""
    return Segment("fresh", stream_ref("next"), counter, _numel(tuple(shape)), how=how,
                   dealer=stream_ref("dealer"), draw_counter=draw_counter,
                   draw_kbits=min(bitlength, 64), emit=emit)


def segment_ttp_share(value: torch.Tensor, counter: int, how: str = "add") -> Segment:
    """The TTP dealer's sharing of a plaintext (ttp_provider.py:41-66):
    parties p >= 1 draw their share from their ``ttp`` stream at
    ``counter``, party 0 gets ``value`` minus (or XOR) their sum."""
    flat = _flat(value, False)
    return Segment("ttp_plain", stream_ref("ttp"), counter, flat.shape[-1], how=how, plain=flat)


def segment_ttp_fresh(shape, bitlength: int, draw_counter: int, counter: int, how: str = "add",
                      emit: bool = False) -> Segment:
    """A dealer draw of ``bitlength`` bits at ``draw_counter``, shared by the
    TTP dealer in the same pass (``emit``: returned beside the shares)."""
    return Segment("ttp_fresh", stream_ref("ttp"), counter, _numel(tuple(shape)), how=how,
                   dealer=stream_ref("dealer"), draw_counter=draw_counter,
                   draw_kbits=min(bitlength, 64), emit=emit)


def launch(segments) -> list:
    """The segments' outputs (``kernels/philox.philox_group``): one launch
    per ``MAX_SEGMENTS`` segments."""
    segments = list(segments)
    out = []
    for i in range(0, len(segments), MAX_SEGMENTS):
        out += philox_group(segments[i:i + MAX_SEGMENTS], device=comm.get_device())
    return out


def shares(out: torch.Tensor, shape) -> torch.Tensor:
    """A sharing segment's output as its (P,) + shape share."""
    return out.reshape((out.shape[0],) + tuple(shape))


def random_kbit(shape, bitlength: int = 64, generator: str = "local"):
    """Uniform k-bit values in [0, 2^bitlength): (shape) for a shared stream,
    (P,) + shape for a per-party one."""
    shape = tuple(shape)
    (rows,) = launch([segment_draw(shape, bitlength, generator, _next_count())])
    if generator in _SHARED:
        return rows[0].reshape(shape)
    return rows.reshape((rows.shape[0],) + shape)


def random_ring(shape, generator: str = "local"):
    """Uniform ring element."""
    return random_kbit(shape, 64, generator)


def przs_arithmetic(shape):
    """Pseudo-random sharing of zero, (P,) + shape: prev-stream minus
    next-stream draw, one Philox launch for all parties."""
    (out,) = launch([segment_zero(shape, _next_count())])
    return shares(out, shape)


def przs_share(value: torch.Tensor, src: int = 0, per_party: bool = False):
    """Dealer sharing of a plaintext: PRZS plus ``value`` on party ``src``.

    ``value`` is party-invariant (shape S) by default, or per party
    ((P,) + S, ``per_party=True``) where only party src's row enters the
    share sum. One fused Philox launch writes only the (P,) + S share."""
    shape = tuple(value.shape[1:] if per_party else value.shape)
    (out,) = launch([segment_share(value, _next_count(), src, per_party)])
    return shares(out, shape)


def przs_binary(shape, bits: int = 64):
    """XOR sharing of zero, (P,) + shape: prev ^ next ring streams."""
    (out,) = launch([segment_zero(shape, _next_count(), "xor", bits)])
    return shares(out, shape)


def xor_share(value: torch.Tensor, src: int = 0, per_party: bool = False):
    """XOR sharing of a plaintext: ``przs_binary`` XOR ``value`` on party
    ``src`` (``per_party`` as in ``przs_share``), in one launch."""
    shape = tuple(value.shape[1:] if per_party else value.shape)
    (out,) = launch([segment_share(value, _next_count(), src, per_party, "xor")])
    return shares(out, shape)
