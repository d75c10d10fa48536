"""The ring_mm kernel's schedule, mirrored in plain torch on the CPU.

``csrc/ring_mm.cu`` cannot run here, so this file repeats its arithmetic
step by step: the balanced int8 digits as the kernel forms them (the bytes
of ``(x + 0x80..80) ^ 0x80..80``), each pair's K cut into 32-k tiles and
the pairs' tiles concatenated, ``split_k``'s chunks of that summed k, eight
int32 diagonal sums per chunk (asserting that no partial sum leaves the
int32 range), each chunk folded into int64 by ``acc_s << 8s`` and the
chunks summed mod 2^64. The mirror is held bit-exact against
``ring._plain_matmul`` and against curl_tpu's ``ring.matmul`` on the same
numpy-seeded operands, at the operands whose digits are extreme, at K
around FLUSH_K and past 2^17, with 1 to 4 pairs; with one SM the chunks are
FLUSH_K long, with 132 they are short and many. It also checks that
``split_k`` fills 132 SMs on the path's long-K products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curl_tpu import ring as jring
from curl_tpu_torch import ring as tring
from curl_tpu_torch.kernels import ring_mm

INT32 = (-(2 ** 31), 2 ** 31 - 1)
BIAS = torch.tensor(0x8080808080808080 - 2 ** 64, dtype=torch.int64)
# int64 values whose balanced digits are extreme: 0x80..80 gives -128 in
# limb 0 and -127 in the others, INT64_MIN -128 in the top limb, -1 -1 in
# the bottom one, 0x7f..7f 127 in every limb
EXTREMES = {"int64_min": -(2 ** 63), "minus_one": -1, "0x7f": 0x7F7F7F7F7F7F7F7F,
            "0x80": 0x8080808080808080 - 2 ** 64}


def kernel_digits(x):
    """(..., 8) int64 digits of x as the kernel forms them."""
    w = (x + BIAS) ^ BIAS
    return torch.stack([(w >> (8 * i)) & 0xFF for i in range(8)], -1).to(torch.uint8).view(
        torch.int8).to(torch.int64)


def mirror(pairs, sms):
    """sum_p A_p @ B_p mod 2^64 (2-D int64) by the kernel's schedule."""
    M, N = pairs[0][0].shape[0], pairs[0][1].shape[1]
    da, db = [], []
    for a, b in pairs:
        pad = -a.shape[1] % ring_mm.TILE_K  # the kernel zero-fills a pair's last tile
        da.append(kernel_digits(torch.nn.functional.pad(a, (0, pad))))
        db.append(kernel_digits(torch.nn.functional.pad(b, (0, 0, 0, pad))))
    da, db = torch.cat(da, 1), torch.cat(db, 0)  # (M, summed k, 8), (summed k, N, 8)
    k_tiles = da.shape[1] // ring_mm.TILE_K
    out_tiles = -(-M // ring_mm.TILE_M) * -(-N // ring_mm.TILE_N)
    chunk, splits = ring_mm.split_k(out_tiles, k_tiles, sms)
    assert chunk * ring_mm.TILE_K <= ring_mm.FLUSH_K and splits == -(-k_tiles // chunk)
    # every plane product of every 32-k tile, (tiles, M, 8, N, 8): a tile's
    # digit products sum to at most 32 * 2^14 in magnitude, exact in float64
    ta = da.reshape(M, k_tiles, ring_mm.TILE_K, 8).permute(1, 0, 3, 2).reshape(k_tiles, M * 8, -1)
    tb = db.reshape(k_tiles, ring_mm.TILE_K, N * 8)
    planes = torch.bmm(ta.double(), tb.double()).to(torch.int64).reshape(k_tiles, M, 8, N, 8)
    diag = torch.zeros(k_tiles, M, N, 8, dtype=torch.int64)  # by tile and diagonal
    for i in range(8):
        for j in range(8 - i):
            diag[..., i + j] += planes[:, :, i, :, j]
    out = torch.zeros(M, N, dtype=torch.int64)
    for c in range(splits):
        partial = diag[c * chunk:(c + 1) * chunk].cumsum(0)  # the int32 sums after each tile
        assert INT32[0] <= int(partial.min()) and int(partial.max()) <= INT32[1]
        acc = partial[-1]
        for s in range(8):
            out += acc[..., s] << (8 * s)  # the chunk's fold; int64 adds wrap mod 2^64
    return out


def _operand(rng, shape, kind):
    if kind == "random":
        return torch.from_numpy(rng.integers(-(2 ** 63), 2 ** 63, size=shape, dtype=np.int64))
    return torch.full(shape, EXTREMES[kind], dtype=torch.int64)


def _curl_tpu(pairs):
    want = np.zeros((pairs[0][0].shape[0], pairs[0][1].shape[1]), dtype=np.uint64)
    for a, b in pairs:
        want += np.asarray(jring.matmul(jnp.asarray(a.numpy().view(np.uint64)),
                                        jnp.asarray(b.numpy().view(np.uint64))))
    return torch.from_numpy(want.view(np.int64))


def test_kernel_digits_are_the_balanced_recoding():
    rng = np.random.default_rng(0)
    edges = [0, 1, 127, 128, -128, -129, 2 ** 63 - 1]
    x = torch.cat([_operand(rng, (4096,), "random"), torch.tensor(list(EXTREMES.values()) + edges)])
    assert torch.equal(kernel_digits(x), tring._balanced_limbs(x).to(torch.int64))


CASES = {
    # name: (M, N, the pairs' K, operand kind, also against curl_tpu)
    **{f"random K {k}": (3, 5, (k,), "random", k == 8193) for k in (8191, 8192, 8193)},
    "random K 2^17+37": (3, 5, (2 ** 17 + 37,), "random", False),
    "random 4 pairs of odd K": (3, 5, (8193, 100, 4000, 37), "random", False),
    "random 4 pairs K 8193": (3, 5, (8193,) * 4, "random", True),
    "random 2 pairs": (8, 7, (3072, 3072), "random", False),
    **{f"{kind} K {k}": (3, 5, (k,), kind, k == 8193)
       for kind in EXTREMES for k in (8191, 8192, 8193)},
    "0x80 K 2^17+37": (3, 5, (2 ** 17 + 37,), "0x80", False),
    "0x80 3 pairs": (3, 5, (8192, 8192, 1000), "0x80", False),
    "int64_min 4 pairs K 8193": (3, 5, (8193,) * 4, "int64_min", True),
}


@pytest.mark.parametrize("sms", [1, ring_mm.H100_SMS])
@pytest.mark.parametrize("name", list(CASES))
def test_mirror_matches_plain_and_curl_tpu(name, sms):
    M, N, ks, kind, vs_curl_tpu = CASES[name]
    rng = np.random.default_rng(sum(ks) + M)
    pairs = [(_operand(rng, (M, k), kind), _operand(rng, (k, N), kind)) for k in ks]
    got = mirror(pairs, sms)
    assert torch.equal(got, ring_mm.plain(pairs))
    # curl_tpu's matmul does not depend on the schedule: once a case, at one
    # shape, (3, 8193) @ (8193, 5), since each new shape costs XLA compiles
    # (tests/test_torch_ring.py holds plain to it past MAX_EXACT_K)
    if vs_curl_tpu and sms == 1:
        assert torch.equal(got, _curl_tpu(pairs))


def _meta(*shape):
    return torch.empty(shape, dtype=torch.int64, device="meta")


# the path's long-K products, in their dealer (one pair) and Beaver (two
# pairs, party axis 2) forms; every GPT-Neo block linear is cut to 2048 x
# 2048 chunks, 24 blocks x (3 + 1 + 4 + 4) = 288 launches a form
LONG_K = {
    "embedding chunk (2,64,6283)@(6283,768)": [(_meta(2, 64, 6283), _meta(6283, 768))],
    "embedding chunk, Beaver": [(_meta(64, 6283), _meta(2, 6283, 768)),
                                (_meta(2, 64, 6283), _meta(6283, 768))],
    "FFN down (64,3072)@(3072,768)": [(_meta(1, 64, 3072), _meta(3072, 768))],
    "FFN down, Beaver": [(_meta(1, 64, 3072), _meta(2, 1, 3072, 768)),
                         (_meta(2, 1, 64, 3072), _meta(3072, 768))],
    "GPT-Neo block (64,2048)@(2048,2048)": [(_meta(1, 64, 2048), _meta(2048, 2048))],
    "GPT-Neo block, Beaver": [(_meta(1, 64, 2048), _meta(2, 1, 2048, 2048)),
                              (_meta(2, 1, 64, 2048), _meta(2048, 2048))],
}


@pytest.mark.parametrize("name", list(LONG_K))
def test_split_k_fills_the_card_on_long_k_products(name):
    g = ring_mm.plan(LONG_K[name], ring_mm.H100_SMS)
    assert g["out_tiles"] * g["splits"] >= ring_mm.H100_SMS
    # chunks start on 32-k tile boundaries, and none is longer than FLUSH_K
    assert ring_mm.FLUSH_K % ring_mm.TILE_K == 0
    assert 1 <= g["chunk"] <= ring_mm.FLUSH_K // ring_mm.TILE_K
    assert g["splits"] == -(-g["k_tiles"] // g["chunk"])


def test_split_k_keeps_a_full_card_whole():
    # 132 output tiles already fill the card: one FLUSH_K-long chunk each
    assert ring_mm.split_k(132, 256, 132) == (256, 1)
    # a K past FLUSH_K is cut however many tiles there are
    chunk, splits = ring_mm.split_k(1000, 300, 132)
    assert chunk * ring_mm.TILE_K <= ring_mm.FLUSH_K and splits >= 2
