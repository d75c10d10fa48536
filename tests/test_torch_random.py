"""The port's random streams: Philox known answers and the invariants that
protocols rest on.

The JAX package's PRZS kernel runs on a TPU only (tests/test_przs_kernel.py)
and the port's Philox streams never match threefry, so nothing here is
compared bit for bit with curl_tpu: the checks are Random123's known
answers, the definition of each Philox mode (pallas_przs.py:14-15: party p
holds PRG(prev_p) - PRG(next_p), plus the plaintext on party src), the
correlation next[p] == prev[p + 1], and determinism of a seeded session.
"""

import numpy as np
import pytest
import torch

import curl_tpu_torch as ct
from curl_tpu_torch import random as rng
from curl_tpu_torch.kernels import philox


def t32(*words):
    return [torch.tensor([w], dtype=torch.int64) for w in words]


@pytest.mark.parametrize(
    "ctr,key,want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ],
)
def test_philox_known_answers(ctr, key, want):
    got = philox.philox4x32_10(*t32(*ctr), *key)
    assert tuple(int(w) for w in got) == want


def test_stream_is_a_function_of_seed_draw_and_index():
    full = philox.stream(0x1234_5678_9ABC_DEF0, 7, 1001, "cpu")
    assert torch.equal(philox.stream(0x1234_5678_9ABC_DEF0, 7, 10, "cpu"), full[:10])
    assert not torch.equal(philox.stream(0x1234_5678_9ABC_DEF0, 8, 10, "cpu"), full[:10])
    # element 2j, 2j+1 are the four words at counter j
    w = philox.philox4x32_10(*t32(3, 0, 7, 0), 0x9ABCDEF0, 0x12345678)
    e0 = (int(w[0]) | int(w[1]) << 32) & ((1 << 64) - 1)
    assert np.int64(full[6]).view(np.uint64) == e0


def test_plain_modes_follow_their_definitions():
    keys = [11, 22, 33]
    n = 9
    rows = [philox.stream(k, 5, n, "cpu") for k in keys]
    przs = philox.plain_philox("przs", keys, 5, n, device="cpu")
    for p in range(3):
        assert torch.equal(przs[p], rows[p - 1] - rows[p])
    assert torch.count_nonzero(przs.sum(0)) == 0
    plain = torch.arange(n, dtype=torch.int64) * 1000
    share = philox.plain_philox("share", keys, 5, n, plain=plain, src=1)
    assert torch.equal(share.sum(0), plain)
    assert torch.equal(share[0], przs[0]) and torch.equal(share[2], przs[2])
    lane = torch.stack([plain, plain + 1, plain + 2])
    share_lane = philox.plain_philox("share_lane", keys, 5, n, plain=lane, src=2)
    assert torch.equal(share_lane.sum(0), plain + 2)
    draw = philox.plain_philox("draw", keys[:1], 5, n, kbits=3, device="cpu")
    assert torch.equal(draw[0], (rows[0] >> 61) & 7)


def test_party_keys_ring_correlation():
    keys = rng.make_party_keys(42, 3)
    for p in range(3):
        assert keys["next"][p] == keys["prev"][(p + 1) % 3]
    assert len(set(keys["next"]) | set(keys["local"]) | set(keys["dealer"])) == 7
    assert rng.make_party_keys(42, 3) == keys != rng.make_party_keys(43, 3)


def test_przs_sums_to_zero_and_binary_xors_to_zero():
    ct.init(world_size=3, seed=1, device="cpu")
    z = rng.przs_arithmetic((4, 5))
    assert z.shape == (3, 4, 5) and torch.count_nonzero(z.sum(0)) == 0
    zb = rng.przs_binary((6,), bits=20)
    assert torch.count_nonzero(zb[0] ^ zb[1] ^ zb[2]) == 0
    assert int(zb.max()) < (1 << 20)


def test_dealer_share_decodes():
    ct.init(world_size=2, seed=2, device="cpu")
    value = rng.random_ring((3, 4), rng.dealer_stream())
    assert value.shape == (3, 4)
    share = rng.przs_share(value)
    assert torch.equal(share.sum(0), value)
    x = np.random.default_rng(0).normal(size=(5,))
    np.testing.assert_allclose(ct.cryptensor(x).get_plain_text(), x, atol=2 ** -16)
    bits = rng.random_kbit((1000,), 1, rng.dealer_stream())
    assert set(bits.unique().tolist()) == {0, 1}


def test_session_is_deterministic_after_init():
    def draws():
        ct.init(world_size=2, seed=9, device="cpu")
        return [rng.przs_arithmetic((3,)), rng.random_ring((2,), "local"),
                ct.cryptensor([1.0, 2.0]).share]

    first = draws()
    rng.random_ring((5,), "dealer")  # unrelated work between sessions
    second = draws()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    rng.reset_count()
    assert torch.equal(rng.przs_arithmetic((3,)), first[0])
