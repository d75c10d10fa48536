"""The pieces of the protocol matrix, each on its own (tests/test_torch_protocols.py
holds the layouts whole).

* The TTP segment of the Philox kernel (``ttp_plain``, ``ttp_fresh``): its
  plain version's shares sum (or XOR) to the value, parties p >= 1 drawn
  from their own ``ttp`` keys; on a card the kernel equals it bit for bit.
* The TTP provider: every method's tuple reconstructs, each sharing counted
  as the JAX package counts it (one ``all_sum`` or ``all_xor`` of one
  party's share).
* The replicated truncation's 3-party scope.
* The tuple one-hot forms: ``generate_one_hot`` through the tuple cache, in
  memory and on disk, and the forms that ``mpc.lut_fastpath: False``,
  ``mpc.fused_onehot: False`` and ``mpc.lut_chunk_elements`` force.
* The HE provider raises; oblivious transfer delivers m_b.

No JAX here: on a card the file runs without the conftest (``python3 -m
pytest --noconftest -m cuda tests/test_torch_ttp.py``). What needs curl_tpu
live (ppermute, the replicated product, the sacrifice check) is in
tests/test_torch_protocols.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import random as trng  # noqa: E402
from curl_tpu_torch import ring as tring  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.kernels import keys as tkeys  # noqa: E402
from curl_tpu_torch.kernels import philox  # noqa: E402
from curl_tpu_torch.kernels.philox import Segment  # noqa: E402
from curl_tpu_torch.mpc import get_default_provider  # noqa: E402
from curl_tpu_torch.mpc.primitives import beaver, replicated  # noqa: E402

TTP_KEYS = (0x1111_2222_3333_4444, 0x5555_6666_7777_8888, 0x9999_AAAA_BBBB_CCCC)
DEALER = 0x0DDB_A11C_0FFE_E5ED


def _ttp_segments(parties, how, n, plain, dev="cpu"):
    """A ttp_plain and a ttp_fresh segment over ``parties`` held keys."""
    ttp, dealer = tkeys.hold(TTP_KEYS[:parties], (DEALER,))
    return [Segment("ttp_plain", ttp, 7, n, how=how, plain=plain),
            Segment("ttp_fresh", ttp, 8, n, how=how, dealer=dealer, draw_counter=9,
                    draw_kbits=1 if how == "xor" else 64, emit=True)]


@pytest.mark.parametrize("parties", [1, 2, 3])
@pytest.mark.parametrize("how", ["add", "xor"])
def test_ttp_segment_shares_reconstruct_from_own_keys(parties, how):
    n = 11  # odd: the last pair holds one element
    plain = torch.randint(-2**63, 2**63 - 1, (n,), dtype=torch.int64,
                          generator=torch.Generator().manual_seed(3))
    (given, (fresh, v)) = philox.plain_philox_group(_ttp_segments(parties, how, n, plain))
    for out, value, counter in ((given, plain, 7), (fresh, v, 8)):
        assert out.shape == (parties, n)
        for p in range(1, parties):  # party p's own ttp stream at the counter
            assert torch.equal(out[p], philox.stream(TTP_KEYS[p], counter, n, "cpu"))
        total = out[0].clone()
        for row in out[1:]:
            total = total + row if how == "add" else total ^ row
        assert torch.equal(total, value)
    # the fresh value is the dealer's draw at its counter, of its bits
    want = philox.stream(DEALER, 9, n, "cpu")
    assert torch.equal(v, (want >> 63) & 1 if how == "xor" else want)


def test_ttp_segment_refuses_a_source_other_than_party_0():
    ttp, = tkeys.hold(TTP_KEYS)
    with pytest.raises(ValueError, match="src is 0"):
        philox.plain_philox_group([Segment("ttp_plain", ttp, 1, 2, src=1,
                                           plain=torch.zeros(2, dtype=torch.int64))])


@pytest.mark.cuda
@pytest.mark.parametrize("parties", [2, 3])
@pytest.mark.parametrize("how", ["add", "xor"])
def test_ttp_segment_kernel_equals_plain_on_the_card(parties, how):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    n = 100_003
    plain = torch.randint(-2**63, 2**63 - 1, (n,), dtype=torch.int64, device=dev)
    segs = _ttp_segments(parties, how, n, plain, dev)
    got = philox.philox_group(segs, dev)
    want = philox.plain_philox_group(segs, dev)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1][0], want[1][0]) and torch.equal(got[1][1], want[1][1])


def test_party_keys_hold_a_ttp_stream_a_party():
    keys = trng.make_party_keys(42, 3)
    assert len(keys["ttp"]) == 3 and len(set(keys["ttp"]) | set(keys["local"])) == 6
    ct.init(world_size=3, seed=42, device="cpu")
    slot = trng.SLOTS["ttp"]
    assert trng.TABLE.host[slot:slot + 3] == keys["ttp"]
    assert trng.stream_ref("ttp").values() == tuple(keys["ttp"])


# -- the TTP provider -----------------------------------------------------------

@pytest.fixture
def ttp3():
    with cfg.temp_override({"mpc.provider": "TTP"}):
        ct.init(world_size=3, seed=8, device="cpu")
        yield get_default_provider()
    ct.init(world_size=2, seed=0, device="cpu")


def _stats():
    s = ct.get_communication_stats()
    return s["rounds"], s["bytes"], s["calls"]


def test_ttp_triples_reconstruct_and_count_one_message_a_sharing(ttp3):
    assert ttp3.NAME == "TTP"
    ct.reset_communication_stats()
    a, b, c = ttp3.generate_additive_triple((2, 3), (3, 4), "matmul")
    assert _stats() == (3, (6 + 12 + 8) * 8, {"all_sum": 3})
    assert torch.equal(tring.matmul(a.share.sum(0), b.share.sum(0)), c.share.sum(0))
    r, r2 = ttp3.square((5,))
    assert torch.equal(r.share.sum(0) * r.share.sum(0), r2.share.sum(0))
    ct.reset_communication_stats()
    a, b, c = ttp3.generate_binary_triple((4,), (2, 4))
    assert _stats() == (3, 3 * 8 * 8, {"all_xor": 3})
    xor = [t.share[0] ^ t.share[1] ^ t.share[2] for t in (a, b, c)]
    assert torch.equal(xor[0] & xor[1], xor[2])


def test_ttp_rng_methods_reconstruct(ttp3):
    r, theta = ttp3.wrap_rng((6,))
    assert torch.equal(tring.count_wraps(r.share), theta.share.sum(0))
    ra, rb = ttp3.B2A_rng((7,))
    bit = ra.share.sum(0)
    assert torch.equal(bit, rb.share[0] ^ rb.share[1] ^ rb.share[2]) and int(bit.max()) <= 1
    r, r_p, b = ttp3.egk_trunc_pr_rng((9,), 62, 16)
    assert int(r.share.sum(0).max()) < 2**46 and int(r_p.share.sum(0).max()) < 2**16
    assert int(b.share.sum(0).max()) <= 1
    ct.reset_communication_stats()
    r, one_hot = ttp3.generate_one_hot((4,), 6)
    assert _stats() == (2, (4 + 24) * 8, {"all_sum": 2})
    rc = r.share.sum(0)
    assert torch.equal(one_hot.share.sum(0), torch.nn.functional.one_hot(rc, 6))


def test_ttp_sharing_is_one_grouped_launch_or_two(ttp3, monkeypatch):
    calls = []
    orig = trng.philox_group
    monkeypatch.setattr(trng, "philox_group", lambda segs, device=None: calls.append(
        [s.what for s in segs]) or orig(segs, device))
    ttp3.generate_additive_triple((4,), (4,), "mul")
    ttp3.egk_trunc_pr_rng((4,), 62, 16)
    ttp3.B2A_rng((4,))
    assert calls == [["ttp_fresh"] * 2, ["ttp_plain"], ["ttp_fresh"] * 3, ["ttp_fresh"] * 2]


def test_he_provider_raises():
    with cfg.temp_override({"mpc.provider": "HE"}):
        ct.init(world_size=2, seed=0, device="cpu")
        with pytest.raises(NotImplementedError, match="HE provider"):
            (ct.cryptensor([1.0]) * ct.cryptensor([2.0])).get_plain_text()
    with pytest.raises(ValueError, match="mpc.provider"):
        from curl_tpu_torch.mpc.provider.provider import get_provider

        get_provider("XYZ")


def test_set_default_provider_and_ttp_required():
    try:
        ct.mpc.set_default_provider("TTP")
        assert ct.mpc.ttp_required() and get_default_provider().NAME == "TTP"
    finally:
        ct.mpc.set_default_provider("TFP")
    assert not ct.mpc.ttp_required() and get_default_provider().NAME == "TFP"


# -- replicated sharing ---------------------------------------------------------

def test_replicated_truncation_needs_three_parties():
    with cfg.temp_override({"mpc.protocol": "replicated"}):
        ct.init(world_size=2, seed=2, device="cpu")
        with pytest.raises(NotImplementedError, match="3 parties"):
            replicated.truncate(ct.cryptensor([1.0])._tensor, 4)


# -- the tuple one-hot forms ----------------------------------------------------------

def _requests(fn):
    provider = get_default_provider()
    provider.requests = []
    ct.trace(True)
    try:
        out = fn()
    finally:
        ct.trace(False)
    funcs = [r.func for r in provider.requests]
    provider.requests = []
    return out, funcs


def test_lut_fastpath_off_takes_the_one_hot_tuple():
    ct.init(world_size=2, seed=3, device="cpu")
    x = ct.cryptensor(np.linspace(-2, 2, 6))
    _, fast = _requests(lambda: x.gelu())
    with cfg.temp_override({"mpc.lut_fastpath": False}):
        out, slow = _requests(lambda: x.gelu())
    assert "generate_lut_masks" in fast and "generate_one_hot" not in fast
    assert "generate_one_hot" in slow and "generate_lut_masks" not in slow
    assert beaver._lut_fastpath_available()


def test_fused_onehot_off_takes_the_one_hot_tuple():
    ct.init(world_size=2, seed=3, device="cpu")
    table = np.random.default_rng(5).normal(size=(7, 3))
    tok = ct.cryptensor(np.array([[1.0, 6.0, 0.0]]), precision=0)
    emb = ct.cryptensor(table)
    out, fast = _requests(lambda: tok.evaluate_embed(emb))
    with cfg.temp_override({"mpc.fused_onehot": False}):
        slow_out, slow = _requests(lambda: tok.evaluate_embed(emb))
    assert "generate_one_hot" not in fast and slow[0] == "generate_one_hot"
    for got in (out, slow_out):
        np.testing.assert_allclose(got.get_plain_text(), table[[1, 6, 0]][None], atol=2**-14)


def test_chunked_one_hot_lut_decodes_like_the_whole_tuple():
    """Above mpc.lut_chunk_elements the TFP one-hot-dot LUT runs in chunks
    of elements: the same rounds and bytes, the same values."""
    x = np.linspace(-2.5, 2.5, 10)
    got = {}
    for limit in (1 << 31, 100):
        with cfg.temp_override({"mpc.lut_fastpath": False, "mpc.lut_chunk_elements": limit}):
            ct.init(world_size=2, seed=3, device="cpu")
            xe = ct.cryptensor(x)
            ct.reset_communication_stats()
            got[limit] = (xe.gelu().get_plain_text(), ct.get_communication_stats())
    assert got[100][1] == got[1 << 31][1]
    np.testing.assert_allclose(got[100][0], got[1 << 31][0], atol=0.02)


def test_generate_one_hot_round_trips_the_tuple_cache(tmp_path):
    with cfg.temp_override({"mpc.lut_fastpath": False}):
        ct.init(world_size=2, seed=3, device="cpu")
        provider = get_default_provider()
        x = np.linspace(-2, 2, 6)
        xe = ct.cryptensor(x)
        provider.requests = []
        ct.trace(True)
        want = xe.gelu().get_plain_text()
        ct.trace(False)
        assert "generate_one_hot" in [r.func for r in provider.requests]
        cache = ct.fill_cache()
        path = tmp_path / "cache"
        provider.save_cache(path)
        loaded = provider.load_cache(path)
        i = cache.funcs.index("generate_one_hot")
        for was, now in zip(cache.entries[i], loaded.entries[i]):  # shares only, no plaintext
            assert type(was) is type(now) and torch.equal(was.share, now.share)
        try:
            served = xe.gelu().get_plain_text()
            assert loaded.cursor == len(loaded.entries)
        finally:
            provider.attach_cache(None)
            provider.requests = []
    np.testing.assert_allclose(served, want, atol=0.05)


# -- oblivious transfer -----------------------------------------------------------------

def test_oblivious_transfer_delivers_the_chosen_message():
    from curl_tpu_torch.mpc.primitives.ot import BaseOT

    messages = [(b"zero-0", b"one--0"), (b"zero-1", b"one--1"), (b"\x00" * 9, b"\xff" * 9)]
    choices = [0, 1, 1]
    assert BaseOT.transfer(messages, choices) == [m[b] for m, b in zip(messages, choices)]
