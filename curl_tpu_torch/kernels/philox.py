"""Wrapper of the CUDA Philox kernel (``csrc/philox.cu``) and its plain version.

``philox_group(segments)`` makes one launch for up to ``MAX_SEGMENTS``
segments and returns one int64 tensor per segment (a pair for an emitted
fresh draw). A segment is a bare draw or a sharing (see ``Segment``):

  draw        (rows, n), row s: the 64-bit stream of ``keys[s]``, logically
              shifted right by ``64 - kbits``;
  zero        (P, n) PRZS: additive, row p stream(keys[p - 1]) -
              stream(keys[p]) (keys are the ring seeds; rows telescope to
              zero over the parties), or XOR, row p (stream(keys[p - 1]) ^
              stream(keys[p])) >> (64 - kbits);
  plain       PRZS plus (or XOR) ``plain`` (n,) on party ``src``;
  plain_lane  PRZS plus (or XOR) ``plain[src]`` of a (P, n) plaintext;
  fresh       PRZS plus (or XOR) the dealer's fresh draw v =
              stream(dealer, draw_counter) >> (64 - draw_kbits) on party
              ``src``; with ``emit`` the output is the pair (shares, v);
  ttp_plain,  the trusted third party's sharing of ``plain`` (n,) or of a
  ttp_fresh   fresh draw v: ``keys`` are the parties' own ``ttp`` seeds,
              row p >= 1 is stream(keys[p]) and row 0 is v minus (or XOR)
              the other rows' sum (curl_tpu/mpc/provider/ttp_provider.py:
              41-66); ``src`` is 0.

``philox(mode, keys, counter, n, ...)`` is the one-segment group of the
first slices' modes (draw, przs, share, share_lane).

Stream element 2j and 2j + 1 are the four words of Philox4x32-10 at counter
(j_lo, j_hi, draw_lo, draw_hi) under key (seed_lo, seed_hi). On a CUDA
device the kernel runs; on the CPU the plain version, ``plain_philox_group``:
the per-segment sequence of ``plain_philox`` calls and torch ops that the
TFP dealer made before the group existed, bit-identical to the kernel.

A segment names its keys (and a fresh draw's dealer key) by slots of a
key table (``keys.KeyRef``), which the kernel loads from the device once
per block and the plain version reads from the table's host mirror: a
captured launch draws from whatever keys the table holds at replay.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from . import build
from .keys import KeyRef

# the first slices' modes, each a one-segment group of what
MODES = {"draw": "draw", "przs": "zero", "share": "plain", "share_lane": "plain_lane"}
MAX_ROWS = 8
# segments a launch takes (csrc/philox.cu's kMaxSegments), and elements a
# segment's row holds (kMaxN: pair indices fit 31 bits)
MAX_SEGMENTS = 16
MAX_N = (1 << 32) - 1
WHATS = {"draw": 0, "zero": 1, "plain": 2, "plain_lane": 3, "fresh": 4}
# the TTP dealer's sharings, the kernel's codes after WHATS'
TTP_WHATS = {"ttp_plain": 5, "ttp_fresh": 6}
TTP = tuple(TTP_WHATS)
# the sharings whose v is a given plaintext, and those that draw it fresh
PLAINS = ("plain", "plain_lane", "ttp_plain")
FRESH = ("fresh", "ttp_fresh")
HOWS = ("add", "xor")
# the kernel's block: threads, and pairs in flight a thread
THREADS = 256
PAIRS_IN_FLIGHT = 2
# resident blocks an SM assumed where the card is not asked (the kernel's
# __launch_bounds__ minimum)
BLOCKS_PER_SM = 4

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_MUL0, _MUL1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

# The fused protocol kernels (fused_mul.cu, max_step.cu) key their draws by
# a Philox counter of the call's draw count and the draw's slot
SLOT_SHIFT = 48
MAX_COUNT = 1 << SLOT_SHIFT

# launches of the kernel, by mode: the "+"-joined tags of a group's
# segments (``Segment.tag``)
launches = {}


class _SegmentArgs(ctypes.Structure):
    """csrc/philox.cu's ``Segment``."""

    _fields_ = [
        ("out", ctypes.c_void_p), ("value", ctypes.c_void_p), ("plain", ctypes.c_void_p),
        ("n", ctypes.c_longlong), ("counter", ctypes.c_uint64), ("draw_counter", ctypes.c_uint64),
        ("block0", ctypes.c_int), ("blocks", ctypes.c_int), ("rows", ctypes.c_int),
        ("what", ctypes.c_int), ("xor_share", ctypes.c_int), ("kbits", ctypes.c_int),
        ("draw_kbits", ctypes.c_int), ("src", ctypes.c_int), ("emit", ctypes.c_int),
        ("slot", ctypes.c_int), ("dealer_slot", ctypes.c_int),
    ]


def _lib():
    lib = build.load("philox")
    if not getattr(lib, "_curl_bound", False):
        lib.philox_group_launch.argtypes = [
            ctypes.POINTER(_SegmentArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.philox_group_launch.restype = ctypes.c_int
        lib.philox_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.philox_blocks_per_sm.restype = ctypes.c_int
        lib.philox_rate_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p,
        ]
        lib.philox_rate_launch.restype = ctypes.c_int
        lib.philox_rate_calls.restype = ctypes.c_int
        lib._curl_bound = True
    return lib


@dataclass(frozen=True, eq=False)
class Segment:
    """One segment of a grouped launch. ``keys``: the key-table slots of a
    draw's stream seeds (one row each), or of a sharing's ring seeds (one
    per party); ``counter``: the draw's, or the sharing streams'; ``kbits``:
    the bits of a draw's rows or of an XOR sharing's streams (an additive
    sharing takes 64); ``fresh`` draws v from the seed in slot ``dealer`` at
    ``draw_counter`` with ``draw_kbits`` bits, and ``emit`` returns v beside
    the shares."""

    what: str
    keys: KeyRef
    counter: int
    n: int
    how: str = "add"
    kbits: int = 64
    src: int = 0
    plain: Optional[torch.Tensor] = None
    dealer: Optional[KeyRef] = None
    draw_counter: int = 0
    draw_kbits: int = 64
    emit: bool = False

    @property
    def rows(self) -> int:
        return self.keys.rows

    @property
    def tag(self) -> str:
        """The launch-count key of a one-segment group (the first slices'
        mode names where there is one)."""
        if self.what == "draw":
            return "draw"
        base = {"zero": "przs", "plain": "share", "plain_lane": "share_lane",
                "fresh": "fresh", "ttp_plain": "ttp_share", "ttp_fresh": "ttp_fresh"}[self.what]
        return base + ("_xor" if self.how == "xor" else "")

    def signature(self) -> tuple:
        """What the kernel's work depends on: (what, how, keys, n, kbits,
        src, draw_kbits, emit)."""
        return (self.what, self.how, self.rows, self.n, self.kbits, self.src,
                self.draw_kbits, self.emit)


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
    """Plain version of one stream: n int64 elements of (key, counter); on
    the meta device (a lazy scope's shape evaluation) their shape only."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(n, dtype=torch.int64, device="meta")
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
    """The first slices' modes in plain torch (any device)."""
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


def _check_segment(seg: Segment):
    if not isinstance(seg.keys, KeyRef):
        raise ValueError("a segment names its keys by key-table slots (keys.KeyRef)")
    if seg.what not in WHATS and seg.what not in TTP_WHATS:
        raise ValueError(f"unknown philox segment {seg.what!r}")
    if seg.how not in HOWS:
        raise ValueError(f"philox sharing is 'add' or 'xor', not {seg.how!r}")
    if not 1 <= seg.rows <= MAX_ROWS:
        raise ValueError(f"philox takes 1 to {MAX_ROWS} keys, got {seg.rows}")
    if seg.what in FRESH and not (isinstance(seg.dealer, KeyRef) and seg.dealer.rows == 1):
        raise ValueError("a fresh draw's dealer key is one key-table slot")
    if not 0 <= seg.n <= MAX_N:
        raise ValueError(f"philox n {seg.n} outside 0..{MAX_N}")
    for bits in (seg.kbits, seg.draw_kbits):
        if not 1 <= bits <= 64:
            raise ValueError(f"kbits {bits} outside 1..64")
    if not all(0 <= c <= _M64 for c in (seg.counter, seg.draw_counter)):
        raise ValueError("philox counters are 64-bit unsigned")
    if seg.what != "draw":
        if not 0 <= seg.src < seg.rows:
            raise ValueError(f"src {seg.src} outside the {seg.rows} parties")
        if (seg.how == "add" or seg.what in TTP) and seg.kbits != 64:
            raise ValueError("an additive or TTP sharing takes 64-bit streams")
    if seg.what in TTP and seg.src != 0:
        raise ValueError("a TTP sharing gives party 0 the rest: src is 0")
    if seg.emit and seg.what not in FRESH:
        raise ValueError("only a fresh draw can be emitted")
    if seg.what in PLAINS:
        want = (seg.rows, seg.n) if seg.what == "plain_lane" else (seg.n,)
        p = seg.plain
        if p is None or p.dtype != torch.int64 or tuple(p.shape) != want:
            raise ValueError(f"philox {seg.what} takes an int64 plain of shape {want}")
        if not p.is_contiguous():
            raise ValueError("philox plain must be contiguous")
    elif seg.plain is not None:
        raise ValueError(f"a philox {seg.what} segment takes no plain")


def _check_group(segments):
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"a philox group takes 1 to {MAX_SEGMENTS} segments, got {len(segments)}")
    for seg in segments:
        _check_segment(seg)
    _table_of(segments)


def _table_of(segments):
    """The one key table the segments' slots name."""
    tables = {id(r.table): r.table for seg in segments for r in (seg.keys, seg.dealer)
              if r is not None}
    if len(tables) != 1:
        raise ValueError("a philox group reads one key table")
    return next(iter(tables.values()))


def _plain_segment(seg: Segment, device) -> torch.Tensor:
    """One segment as the TFP dealer computed it before the group: the
    plain_philox calls and torch ops, in order (key slots read from the
    table's host mirror)."""
    keys = list(seg.keys.values())
    P = len(keys)
    if seg.what == "draw":
        return plain_philox("draw", keys, seg.counter, seg.n, kbits=seg.kbits, device=device)
    if seg.what in FRESH:
        v = plain_philox("draw", [seg.dealer.value()], seg.draw_counter, seg.n,
                         kbits=seg.draw_kbits, device=device)[0]
    else:
        v = seg.plain
    if seg.what in TTP:
        out = _plain_ttp(keys, seg.counter, seg.n, v, seg.how)
    elif seg.how == "add":
        if seg.what == "zero":
            out = plain_philox("przs", keys, seg.counter, seg.n, device=device)
        elif seg.what == "plain_lane":
            out = plain_philox("share_lane", keys, seg.counter, seg.n, plain=v, src=seg.src)
        else:
            out = plain_philox("share", keys, seg.counter, seg.n, plain=v, src=seg.src)
    else:  # the per-call XOR sharing: a 2-row draw, a roll and a masked XOR
        ring = plain_philox("draw", keys, seg.counter, seg.n, kbits=seg.kbits, device=device)
        out = torch.roll(ring, 1, dims=0) ^ ring
        if v is not None:
            mask = torch.zeros((P, 1), dtype=torch.int64, device=device)
            mask[seg.src] = 1
            out = out ^ (v * mask if seg.what != "plain_lane" else v[seg.src] * mask)
    return (out, v) if seg.emit else out


def _plain_ttp(keys, counter, n, v, how):
    """The TTP dealer's sharing of v (curl_tpu/mpc/provider/ttp_provider.py:
    41-66) in plain torch: parties p >= 1 draw their ttp stream, party 0
    takes v minus (or XOR) their sum."""
    rest = plain_philox("draw", keys[1:], counter, n, device=v.device) if len(keys) > 1 else None
    if rest is None:
        return v.clone()[None]
    if how == "add":
        first = v - rest.sum(0)
    else:
        first = v.clone()
        for row in rest:
            first ^= row
    return torch.cat([first[None], rest])


def plain_philox_group(segments, device=None):
    """The group's function in plain torch (any device): one output per
    segment, as ``philox_group``'s."""
    _check_group(segments)
    return [_plain_segment(seg, seg.plain.device if seg.plain is not None else device)
            for seg in segments]


def plan(segments, sms: int, blocks_per_sm: int = BLOCKS_PER_SM) -> dict:
    """The launch's blocks: segment s gets ``blocks[s]`` blocks from
    ``block0[s]`` on, enough for ``PAIRS_IN_FLIGHT`` pairs a thread and at
    most a wave of the card (``sms * blocks_per_sm``); a segment of no
    elements none."""
    cap = max(1, sms * blocks_per_sm)
    block0, blocks, total = [], [], 0
    for seg in segments:
        pairs = (seg.n + 1) // 2
        b = min(-(-pairs // (THREADS * PAIRS_IN_FLIGHT)), cap)
        block0.append(total)
        blocks.append(b)
        total += b
    return {"block0": block0, "blocks": blocks, "grid": total}


def _device_of(segments, device):
    for seg in segments:
        if seg.plain is not None:
            return seg.plain.device
    return torch.device(device)


_blocks_per_sm = {}


def _resident_blocks(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _blocks_per_sm:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            build.check(_lib().philox_blocks_per_sm(ctypes.byref(n)), "philox occupancy")
        _blocks_per_sm[idx] = max(1, n.value)
    return _blocks_per_sm[idx]


def philox_group(segments, device=None):
    """One output per segment: ``(rows, n)`` for a draw, ``(P, n)`` for a
    sharing, the pair ``((P, n), (n,))`` of shares and v for an emitted
    fresh draw (v in its own buffer, so that the shares do not keep it
    alive). One launch of the kernel on a CUDA device; the plain version
    on the CPU."""
    segments = list(segments)
    device = _device_of(segments, device)
    if device.type != "cuda":
        return plain_philox_group(segments, device)
    _check_group(segments)
    for seg in segments:
        if seg.plain is not None and seg.plain.device != device:
            raise ValueError(f"philox plain on {seg.plain.device}, not {device}")
    outs = [torch.empty((seg.rows, seg.n), dtype=torch.int64, device=device)
            for seg in segments]
    values = [torch.empty(seg.n, dtype=torch.int64, device=device) if seg.emit else None
              for seg in segments]
    live = [(seg, out, value) for seg, out, value in zip(segments, outs, values) if seg.n > 0]
    outs = [out if value is None else (out, value) for out, value in zip(outs, values)]
    if not live:
        return outs
    p = plan([seg for seg, _, _ in live],
             torch.cuda.get_device_properties(device).multi_processor_count,
             _resident_blocks(device))
    table = _table_of([seg for seg, _, _ in live])
    args = (_SegmentArgs * len(live))()
    for i, (a, (seg, out, value)) in enumerate(zip(args, live)):
        a.out = out.data_ptr()
        a.value = value.data_ptr() if value is not None else None
        a.plain = seg.plain.data_ptr() if seg.plain is not None else None
        a.n = seg.n
        a.slot = seg.keys.slot
        a.dealer_slot = seg.dealer.slot if seg.what in FRESH else 0
        a.counter, a.draw_counter = seg.counter, seg.draw_counter
        a.block0, a.blocks = p["block0"][i], p["blocks"][i]
        a.rows, a.xor_share = seg.rows, int(seg.how == "xor")
        a.what = WHATS[seg.what] if seg.what in WHATS else TTP_WHATS[seg.what]
        a.kbits, a.draw_kbits, a.src, a.emit = seg.kbits, seg.draw_kbits, seg.src, int(seg.emit)
    with torch.cuda.device(device):
        stream_ptr = torch.cuda.current_stream(device).cuda_stream
        rc = _lib().philox_group_launch(args, len(live), p["grid"],
                                        table.tensor(device).data_ptr(), stream_ptr)
    build.check(rc, "philox")
    mode = "+".join(sorted({seg.tag for seg in segments}))
    launches[mode] = launches.get(mode, 0) + 1
    return outs


def philox(mode, keys: KeyRef, counter, n, plain=None, src=0, kbits=64, device=None):
    """(rows, n) int64 of one of the first slices' modes: a one-segment
    group, ``plain_philox`` of the keys in slots ``keys``; ``counter``: the
    draw."""
    _check(mode, keys.values(), n, plain, src, kbits)
    seg = Segment(MODES[mode], keys, counter & _M64, n,
                  kbits=kbits if mode == "draw" else 64, src=src, plain=plain)
    return philox_group([seg], device)[0]


def rate_calls() -> int:
    """Philox calls a thread of the kernel ``philox_rate_kernel``."""
    return _lib().philox_rate_calls()


def launch_rate(threads: int, device, twice: bool = False) -> torch.Tensor:
    """The Philox-only kernel: ``threads`` x ``rate_calls()`` (x 2 with
    ``twice``) calls, one XOR-folded uint32 a thread (as int32)."""
    out = torch.empty(threads, dtype=torch.int32, device=device)
    with torch.cuda.device(out.device):
        stream_ptr = torch.cuda.current_stream(out.device).cuda_stream
        rc = _lib().philox_rate_launch(out.data_ptr(), threads, int(twice), 0x0123456789ABCDEF,
                                       stream_ptr)
    build.check(rc, "philox_rate")
    return out


def reset_launches():
    launches.clear()
