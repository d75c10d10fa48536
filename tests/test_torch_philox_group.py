"""The grouped Philox launch (``kernels/philox.philox_group``) on the CPU.

The group's plain version is, by definition, the per-call sequence of
``plain_philox`` calls and torch ops that the TFP dealer made before one
launch served a whole dealer call; that sequence is written out here and
held to it bit for bit over random segment lists. The launch plan
(``philox.plan``) and the kernel's pair loop, mirrored in
``block_pairs`` here, must write every pair of every segment once. Each
TFP provider method must return the shares the per-call composition gave
for the same session seed, in the number of launches its docstring names,
with the same CommStats. The kernel itself runs only on a card
(tests/test_torch_kernels.py, chip_smoke.py).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_philox_group.py -q
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import curl_tpu_torch as ct
from curl_tpu_torch import comm
from curl_tpu_torch import random as rng
from curl_tpu_torch.kernels import philox
from curl_tpu_torch.kernels.keys import KeyRef, KeyTable, hold
from curl_tpu_torch.mpc.primitives.arithmetic import ArithmeticSharedTensor
from curl_tpu_torch.mpc.primitives.beaver import _RING_OPS
from curl_tpu_torch.mpc.primitives.binary import BinarySharedTensor
from curl_tpu_torch.mpc.provider.tfp_provider import TrustedFirstParty

M64 = (1 << 64) - 1


def u64(x: int) -> int:
    return x & M64


# ---------------------------------------------------------------------------
# plain_philox_group against the per-call sequence
# ---------------------------------------------------------------------------

def per_call(seg: philox.Segment) -> torch.Tensor:
    """One segment as the per-call dealer code computed it."""
    keys = list(seg.keys.values())
    P = len(keys)
    if seg.what == "draw":
        return philox.plain_philox("draw", keys, seg.counter, seg.n, kbits=seg.kbits,
                                   device="cpu")
    v = seg.plain
    if seg.what == "fresh":  # random.random_kbit(shape, draw_kbits, "dealer")
        v = philox.plain_philox("draw", [seg.dealer.value()], seg.draw_counter, seg.n,
                                kbits=seg.draw_kbits, device="cpu")[0]
    if seg.how == "add":  # random.przs_arithmetic / przs_share
        if seg.what == "zero":
            out = philox.plain_philox("przs", keys, seg.counter, seg.n, device="cpu")
        else:
            mode = "share_lane" if seg.what == "plain_lane" else "share"
            out = philox.plain_philox(mode, keys, seg.counter, seg.n, plain=v, src=seg.src)
    else:  # random.przs_binary, then tfp_provider._bshare_from_local's masked XOR
        ring = philox.plain_philox("draw", keys, seg.counter, seg.n, kbits=seg.kbits,
                                   device="cpu")
        out = torch.roll(ring, 1, dims=0) ^ ring
        if v is not None:
            row = v[seg.src] if seg.what == "plain_lane" else v
            mask = torch.zeros((P, 1), dtype=torch.int64)
            mask[seg.src] = 1
            out = out ^ (row * mask)
    return (out, v) if seg.emit else out


def by_definition(seg: philox.Segment, keys=None, dealer=None) -> np.ndarray:
    """The segment from the streams alone, in numpy uint64: of ``keys`` and
    ``dealer`` where given, else of what its slots hold."""
    keys = seg.keys.values() if keys is None else keys
    st = [philox.stream(k, seg.counter, seg.n, "cpu").numpy().view(np.uint64) for k in keys]
    if seg.what == "draw":
        return np.stack([s >> np.uint64(64 - seg.kbits) for s in st])
    P = len(st)
    if seg.what == "fresh":
        dealer = seg.dealer.value() if dealer is None else dealer
        v = philox.stream(dealer, seg.draw_counter, seg.n, "cpu").numpy().view(np.uint64)
        v = v >> np.uint64(64 - seg.draw_kbits)
    elif seg.what == "plain":
        v = seg.plain.numpy().view(np.uint64)
    elif seg.what == "plain_lane":
        v = seg.plain[seg.src].numpy().view(np.uint64)
    else:
        v = np.zeros(seg.n, dtype=np.uint64)
    rows = []
    for p in range(P):
        prev, cur = st[(p - 1) % P], st[p]
        if seg.how == "add":
            row = prev - cur + (v if p == seg.src else np.uint64(0))
        else:
            row = (prev ^ cur) >> np.uint64(64 - seg.kbits)
            row = row ^ (v if p == seg.src else np.uint64(0))
        rows.append(row)
    return (np.stack(rows), v) if seg.emit else np.stack(rows)


def random_segment(g: np.random.Generator, table: KeyTable, i: int) -> philox.Segment:
    """A random segment, its keys in slots of ``table`` (segment ``i``'s
    dealer key at slot i * (MAX_ROWS + 1), its rows' keys after it)."""
    what = str(g.choice(list(philox.WHATS)))
    how = "add" if what == "draw" else str(g.choice(philox.HOWS))
    n = int(g.choice([1, 2, 3, 31, 64, 257, 1000, 1001]))
    rows = int(g.integers(1, philox.MAX_ROWS + 1))
    keys = tuple(int(k) * 2 + 1 for k in g.integers(0, 2 ** 63, size=rows))
    kbits = int(g.choice([1, 20, 63, 64])) if what == "draw" or how == "xor" else 64
    src = int(g.integers(0, min(rows, 2)))
    plain = None
    if what == "plain":
        plain = torch.from_numpy(g.integers(-2 ** 63, 2 ** 63 - 1, size=n, dtype=np.int64))
    elif what == "plain_lane":
        plain = torch.from_numpy(g.integers(-2 ** 63, 2 ** 63 - 1, size=(rows, n), dtype=np.int64))
    counter = int(g.integers(0, 2 ** 62))
    base = i * (philox.MAX_ROWS + 1)
    table.write([int(g.integers(0, 2 ** 63)) if what == "fresh" else 0] + list(keys), base)
    return philox.Segment(
        what, table.ref(base + 1, rows), counter, n, how=how, kbits=kbits, src=src, plain=plain,
        dealer=table.ref(base) if what == "fresh" else None,
        draw_counter=int(g.integers(0, 2 ** 40)),
        draw_kbits=int(g.choice([1, 12, 48, 64])) if what == "fresh" else 64,
        emit=what == "fresh" and bool(g.integers(0, 2)))


def random_group(g: np.random.Generator) -> list:
    """MAX_SEGMENTS random segments, their keys in one table."""
    table = KeyTable(philox.MAX_SEGMENTS * (philox.MAX_ROWS + 1))
    return [random_segment(g, table, i) for i in range(philox.MAX_SEGMENTS)]


@pytest.mark.parametrize("seed", range(4))
def test_plain_group_is_the_per_call_sequence(seed):
    g = np.random.default_rng(seed)
    segments = random_group(g)
    got = philox.plain_philox_group(segments, device="cpu")
    assert len(got) == len(segments)
    for seg, out in zip(segments, got):
        want, defined = per_call(seg), by_definition(seg)
        if seg.emit:  # (shares, value)
            (out, value), (want, want_value), (defined, defined_value) = out, want, defined
            assert value.shape == (seg.n,) and torch.equal(value, want_value), seg.signature()
            assert np.array_equal(value.numpy().view(np.uint64), defined_value)
        assert out.shape == (seg.rows, seg.n) and out.dtype == torch.int64
        assert torch.equal(out, want), seg.signature()
        assert np.array_equal(out.numpy().view(np.uint64), defined), seg.signature()


def test_group_covers_every_kind_and_shape():
    # the random lists above draw from these; make sure each one occurs
    seen = set()
    for seed in range(4):
        g = np.random.default_rng(seed)
        for s in random_group(g):
            seen |= {("what", s.what), ("how", s.how), ("n", s.n), ("rows", s.rows),
                     ("src", s.src), ("kbits", s.kbits), ("emit", s.emit)}
    for key in [("what", w) for w in philox.WHATS] + [("how", h) for h in philox.HOWS] + [
            ("n", 1), ("rows", 1), ("rows", 8), ("src", 0), ("src", 1), ("kbits", 1),
            ("kbits", 64), ("emit", True)]:
        assert key in seen, key


def test_group_refuses_bad_segments():
    keys, nine, dealer = hold((3, 5), (1,) * 9, (13,))
    other, = hold((3, 5))
    bad = (
        [],                                                                 # no segment
        [philox.Segment("draw", keys, 0, 4)] * (philox.MAX_SEGMENTS + 1),   # too many
        [philox.Segment("zero", keys, 0, 4, kbits=20)],                     # additive, 20 bits
        [philox.Segment("zero", keys, 0, 4, src=2)],                        # src outside
        [philox.Segment("plain", keys, 0, 4)],                              # no plain
        [philox.Segment("plain", keys, 0, 4, plain=torch.zeros(5, dtype=torch.int64))],
        [philox.Segment("zero", keys, 0, 4, emit=True)],                    # emit not fresh
        [philox.Segment("fresh", keys, 0, 4, dealer=dealer, draw_kbits=0)],
        [philox.Segment("fresh", keys, 0, 4)],                              # no dealer slot
        [philox.Segment("fresh", keys, 0, 4, dealer=keys)],                 # dealer of 2 slots
        [philox.Segment("draw", nine, 0, 4)],                               # rows > 8
        [philox.Segment("draw", (3, 5), 0, 4)],                             # keys not slots
        [philox.Segment("draw", keys, -1, 4)],                              # counter not u64
        [philox.Segment("draw", keys, 0, 4), philox.Segment("draw", other, 0, 4)],  # 2 tables
        [philox.Segment("zero", keys, 0, 4, how="or")],
        [philox.Segment("zero", keys, 0, philox.MAX_N + 1)],                # n past 32 bits
    )
    for segments in bad:
        with pytest.raises(ValueError):
            philox.plain_philox_group(segments, device="cpu")


def test_one_segment_group_is_the_first_slices_mode():
    keys = [u64(-7), 11]
    ref, = hold(keys)
    plain = torch.arange(33, dtype=torch.int64) * 977
    for mode, kw in (("draw", {"kbits": 9}), ("przs", {}), ("share", {"plain": plain, "src": 1}),
                     ("share_lane", {"plain": torch.stack([plain, -plain]), "src": 1})):
        assert torch.equal(philox.philox(mode, ref, 6, 33, device="cpu", **kw),
                           philox.plain_philox(mode, keys, 6, 33, device="cpu", **kw))


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def block_pairs(segments, p: dict, block: int):
    """(segment, pair indices) that block ``block`` of plan ``p`` writes:
    csrc/philox.cu's segment search and pair loop, mirrored."""
    s = sum(block >= b0 for b0 in p["block0"][1:])
    pairs = (segments[s].n + 1) // 2
    stride = p["blocks"][s] * philox.THREADS
    first = (torch.arange(philox.THREADS, dtype=torch.int64)
             + (block - p["block0"][s]) * philox.THREADS)
    j0 = torch.arange(0, pairs, philox.PAIRS_IN_FLIGHT * stride, dtype=torch.int64)
    u = torch.arange(philox.PAIRS_IN_FLIGHT, dtype=torch.int64) * stride
    j = (j0[:, None, None] + u[None, :, None] + first[None, None, :]).reshape(-1)
    return s, j[j < pairs]


# the path's largest segment: a dealer triple's b for a (768, 6283) vocab
# chunk, drawn, emitted and shared by 2 parties
VOCAB_CHUNK = 768 * 6283


@pytest.mark.parametrize("sizes", [(VOCAB_CHUNK, 1, 63, 64 * 768), (1, 2, 3, 1001, 256 * 1024 + 1)])
def test_plan_writes_every_pair_once(sizes):
    sms, per_sm = 132, philox.BLOCKS_PER_SM
    keys, dealer = hold((1, 2), (3,))
    segments = [philox.Segment("fresh", keys, 0, n, dealer=dealer, emit=True) for n in sizes]
    p = philox.plan(segments, sms, per_sm)
    assert p["grid"] == sum(p["blocks"]) and p["block0"][0] == 0
    seen = [torch.zeros((seg.n + 1) // 2, dtype=torch.int64) for seg in segments]
    for block in range(p["grid"]):
        s, pairs = block_pairs(segments, p, block)
        seen[s] += torch.bincount(pairs, minlength=seen[s].numel())
    for seg, counts in zip(segments, seen):
        assert torch.all(counts == 1), seg.n
    for seg, blocks in zip(segments, p["blocks"]):
        pairs = (seg.n + 1) // 2
        # PAIRS_IN_FLIGHT pairs a thread, at most a wave of the card
        assert blocks == min(-(-pairs // (philox.THREADS * philox.PAIRS_IN_FLIGHT)), sms * per_sm)
    if sizes[0] == VOCAB_CHUNK:
        assert p["blocks"][0] == sms * per_sm  # one whole wave on the largest


def test_segment_table_fits_the_kernel_parameters():
    # csrc/philox.cu's Group: the key table's address, MAX_SEGMENTS segments
    # (each naming its keys by their first slot and its dealer's slot, no key
    # itself) and a count, under 4 KB
    assert ctypes.sizeof(philox._SegmentArgs) == 96
    assert 8 + philox.MAX_SEGMENTS * (ctypes.sizeof(philox._SegmentArgs) + 4) + 8 <= 4096


# ---------------------------------------------------------------------------
# the TFP provider against its per-call composition
# ---------------------------------------------------------------------------

def przs_binary_per_call(shape, bits=64):
    ring = rng.random_kbit(shape, bits, "next")
    return torch.roll(ring, 1, dims=0) ^ ring


def share_per_call(value):
    return ArithmeticSharedTensor.from_shares(rng.przs_share(value), precision=0)


def bshare_per_call(value):
    share = przs_binary_per_call(tuple(value.shape))
    return BinarySharedTensor.from_shares(share ^ (value * comm.rank_mask(0, value.dim())))


class PerCallTFP:
    """The TFP provider as it was: one launch per draw and per share."""

    def generate_additive_triple(self, size0, size1, op):
        a = rng.random_ring(size0, rng.dealer_stream())
        b = rng.random_ring(size1, rng.dealer_stream())
        c = _RING_OPS[op](a, b)
        return share_per_call(a), share_per_call(b), share_per_call(c)

    def square(self, size):
        r = rng.random_ring(size, rng.dealer_stream())
        return share_per_call(r), share_per_call(r * r)

    def generate_binary_triple(self, size0, size1):
        a = rng.random_kbit(size0, 64, rng.dealer_stream())
        b = rng.random_kbit(size1, 64, rng.dealer_stream())
        c = a & b
        shape = torch.broadcast_shapes(tuple(size0), tuple(size1))
        return tuple(bshare_per_call(v.expand(shape)) for v in (a, b, c))

    def wrap_rng(self, size):
        from curl_tpu_torch import ring

        planes = torch.stack(
            [rng.random_ring(size, rng.dealer_stream()) for _ in range(comm.get_world_size())])
        theta_r = ring.count_wraps(planes)
        r = ArithmeticSharedTensor.from_shares(comm.scatter(planes, src=0), precision=0)
        return r, share_per_call(theta_r)

    def B2A_rng(self, size):
        r = rng.random_kbit(size, 1, rng.dealer_stream())
        return share_per_call(r), bshare_per_call(r)

    def generate_lut_masks(self, tensor_size, lut_size, n_tables):
        r = rng.random_ring(tensor_size, rng.dealer_stream())
        r_clear = torch.remainder(r, lut_size)
        r_shares = share_per_call(r_clear)
        masks = [rng.przs_arithmetic(tuple(tensor_size)) for _ in range(n_tables)]
        return r_clear, r_shares, masks

    def egk_trunc_pr_rng(self, size, l, m):
        r = rng.random_kbit(size, l - m, rng.dealer_stream())
        r_p = rng.random_kbit(size, m, rng.dealer_stream())
        b = rng.random_kbit(size, 1, rng.dealer_stream())
        return share_per_call(r), share_per_call(r_p), share_per_call(b)


def tensors(x):
    """Every tensor of a provider result, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (ArithmeticSharedTensor, BinarySharedTensor)):
        return [x.share]
    return [t for item in x for t in tensors(item)]


# (method, args, group launches)
PROVIDER_CALLS = [
    ("generate_additive_triple", ((64, 48), (48, 40), "matmul"), 2),
    ("generate_additive_triple", ((2, 3, 5), (5,), "mul"), 2),
    ("square", ((7, 9),), 2),
    ("generate_binary_triple", ((4, 33), (33,)), 2),
    ("generate_binary_triple", ((1,), (1,)), 2),
    ("egk_trunc_pr_rng", ((5, 13), 64, 16), 1),
    ("egk_trunc_pr_rng", ((3,), 40, 1), 1),
    ("B2A_rng", ((11, 3),), 1),
    ("generate_lut_masks", ((31,), 256, 2), 2),
    ("generate_lut_masks", ((6,), 10, 1), 2),
    ("generate_lut_masks", ((4,), 64, philox.MAX_SEGMENTS), 3),  # 17 sharings: 2 launches
    ("wrap_rng", ((5,),), 2),
]


@pytest.mark.parametrize("world_size", [2, 3])
@pytest.mark.parametrize("method,args,groups", PROVIDER_CALLS)
def test_provider_matches_per_call_composition(method, args, groups, world_size, monkeypatch):
    ct.init(world_size=world_size, seed=17, device="cpu")
    ct.reset_communication_stats()
    want = getattr(PerCallTFP(), method)(*args)
    want_stats = ct.get_communication_stats()
    want_count = rng._counter

    calls = []
    orig = rng.philox_group

    def counting(segments, device=None):
        calls.append(len(segments))
        return orig(segments, device)

    monkeypatch.setattr(rng, "philox_group", counting)
    ct.init(world_size=world_size, seed=17, device="cpu")
    ct.reset_communication_stats()
    got = getattr(TrustedFirstParty(), method)(*args)
    stats = ct.get_communication_stats()

    assert len(calls) == groups, calls
    assert rng._counter == want_count  # as many counters, reserved in order
    assert (stats["rounds"], stats["bytes"]) == (want_stats["rounds"], want_stats["bytes"])
    got_t, want_t = tensors(got), tensors(want)
    assert len(got_t) == len(want_t)
    for g_, w_ in zip(got_t, want_t):
        assert g_.shape == w_.shape and torch.equal(g_, w_)


def test_binary_encrypt_and_przs_binary_match_per_call():
    ct.init(world_size=3, seed=5, device="cpu")
    zb = przs_binary_per_call((4, 7), bits=20)
    value = torch.arange(12, dtype=torch.int64).reshape(3, 4) * 12345
    lane = torch.stack([value, value + 1, value + 2])
    enc = przs_binary_per_call((3, 4)) ^ (value * comm.rank_mask(1, 2))
    enc_lane = przs_binary_per_call((3, 4)) ^ (lane * comm.rank_mask(2, 2))
    ct.init(world_size=3, seed=5, device="cpu")
    assert torch.equal(rng.przs_binary((4, 7), bits=20), zb)
    assert torch.equal(BinarySharedTensor.encrypt(value, src=1).share, enc)
    assert torch.equal(BinarySharedTensor.encrypt(lane, src=2, per_party=True).share, enc_lane)


# ---------------------------------------------------------------------------
# key-table slots against literal keys
# ---------------------------------------------------------------------------

# every segment kind: (what, how); a bare draw is never XOR-shared
KINDS = [(w, h) for w in philox.WHATS for h in philox.HOWS if w != "draw" or h == "add"]


def slot_twins(what, how, rows, table):
    """The literal keys and dealer key of a segment, and the segment naming
    them by slots of ``table`` (rows from slot 1, the dealer's at slot 0)."""
    g = np.random.default_rng(rows * 31 + len(what))
    keys = tuple(int(k) * 2 + 1 for k in g.integers(0, 2 ** 63, size=rows))
    dealer = int(g.integers(0, 2 ** 63))
    n = 1001
    plain = None
    if what == "plain":
        plain = torch.from_numpy(g.integers(-2 ** 63, 2 ** 63 - 1, size=n, dtype=np.int64))
    elif what == "plain_lane":
        plain = torch.from_numpy(g.integers(-2 ** 63, 2 ** 63 - 1, size=(rows, n), dtype=np.int64))
    table.write([dealer] + list(keys))
    slotted = philox.Segment(what, table.ref(1, rows), 5, n, how=how,
                             kbits=20 if how == "xor" or what == "draw" else 64, src=rows - 1,
                             plain=plain, dealer=table.ref(0) if what == "fresh" else None,
                             draw_counter=77, draw_kbits=48 if what == "fresh" else 64,
                             emit=what == "fresh")
    return keys, dealer, slotted


def _as_numpy(out):
    """A segment's output (shares, or the pair of shares and v) in uint64."""
    outs = out if isinstance(out, tuple) else (out,)
    return [o.cpu().numpy().view(np.uint64) for o in outs]


def _outputs_equal(a, b):
    a = list(a) if isinstance(a, (list, tuple)) else [a]
    b = list(b) if isinstance(b, (list, tuple)) else [b]
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("rows", [2, 3])
@pytest.mark.parametrize("what,how", KINDS)
def test_plain_group_reads_slots_as_the_literal_keys(what, how, rows):
    table = KeyTable(1 + philox.MAX_ROWS)
    keys, dealer, slotted = slot_twins(what, how, rows, table)
    want = by_definition(slotted, keys, dealer)
    (got,) = philox.plain_philox_group([slotted], device="cpu")
    assert _outputs_equal(_as_numpy(got), want), (what, how)
    # the slots are read when the group runs: new keys, new streams
    table.write([k ^ 1 for k in table.host])
    (moved,) = philox.plain_philox_group([slotted], device="cpu")
    assert _outputs_equal(_as_numpy(moved), by_definition(slotted))
    assert not _outputs_equal(_as_numpy(moved), want)


def test_session_segments_name_the_key_table():
    ct.init(world_size=3, seed=9, device="cpu")
    table = rng.TABLE
    keys = rng.current_keys()
    seg = rng.segment_fresh((4,), 64, 1, 2)
    assert isinstance(seg.keys, KeyRef) and seg.keys.table is table
    assert seg.keys.values() == tuple(keys["next"]) and seg.dealer.value() == keys["dealer"][0]
    assert rng.segment_draw((4,), 64, "local", 3).keys.values() == tuple(keys["local"])
    assert rng.segment_draw((4,), 64, "global", 3).keys.values() == tuple(keys["global"])
    assert rng.fused_key().value() == keys["fused"][0]
    ct.init(world_size=2, seed=10, device="cpu")
    assert rng.TABLE is table  # written in place, never reallocated
    assert seg.dealer.value() == rng.current_keys()["dealer"][0]


def test_key_table_device_copy_is_written_in_place():
    table = KeyTable(4)
    table.write([1, 2 ** 64 - 1], 1)
    dev = table.tensor("cpu")
    assert dev.tolist() == [0, 1, -1, 0]
    ptr = dev.data_ptr()
    table.write([7], 3)
    assert table.tensor("cpu").data_ptr() == ptr and dev.tolist() == [0, 1, -1, 7]
    assert table.host == [0, 1, 2 ** 64 - 1, 7]
    with pytest.raises(ValueError):
        table.write([1, 2], 3)
    with pytest.raises(ValueError):
        table.ref(3, 2)


@pytest.mark.cuda
def test_group_kernel_reads_slots_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    table = KeyTable(1 + philox.MAX_ROWS)
    for rows in (2, 3):
        for what, how in KINDS:
            keys, dealer, slotted = slot_twins(what, how, rows, table)
            if slotted.plain is not None:
                slotted = dataclasses.replace(slotted, plain=slotted.plain.cuda())
            want = by_definition(dataclasses.replace(slotted, plain=None if slotted.plain is None
                                                     else slotted.plain.cpu()), keys, dealer)
            (got,) = philox.philox_group([slotted], "cuda")
            (two,) = philox.philox_group([slotted, slotted], "cuda")[1:]
            assert _outputs_equal(_as_numpy(got), want), (what, how, rows)
            assert _outputs_equal(_as_numpy(two), want), (what, how, rows)
            table.write([k ^ 1 for k in table.host])
            (moved,) = philox.philox_group([slotted], "cuda")
            (plain,) = philox.plain_philox_group([slotted], "cuda")
            assert _outputs_equal(_as_numpy(moved), _as_numpy(plain))
            assert not _outputs_equal(_as_numpy(moved), want)
