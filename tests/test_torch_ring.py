"""The port's ring arithmetic, limb matmul and encoder, bit for bit against
curl_tpu.

The same numpy inputs go through ``curl_tpu.ring`` (uint64) and
``curl_tpu_torch.ring`` (int64 with two's-complement wrap); results must be
equal as 64-bit patterns. The ring-mm kernel's plain version is also held
against the JAX package's Pallas kernel in interpret mode, as
tests/test_pallas_ring_mm.py runs it. The CUDA kernel itself is checked
against the plain version by the test marked ``cuda`` (and by
chip_smoke.py on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curl_tpu import encoder as jenc
from curl_tpu import ring as jring
from curl_tpu.ops import pallas_ring_mm as pmm

import curl_tpu_torch as ct
from curl_tpu_torch import encoder as tenc
from curl_tpu_torch import ring as tring
from curl_tpu_torch.kernels import ring_mm


def u64(rng, shape):
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def T(a):
    """uint64 numpy -> int64 torch (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def same(got_torch, want_jax):
    np.testing.assert_array_equal(
        got_torch.numpy().view(np.uint64), np.asarray(want_jax).astype(np.uint64)
    )


@pytest.fixture
def ab():
    rng = np.random.default_rng(11)
    a = u64(rng, (257,))
    b = u64(rng, (257,))
    a[:4] = [0, 1, (1 << 63), (1 << 64) - 1]
    return a, b


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg"])
def test_elementwise_wraps_like_uint64(ab, op):
    a, b = ab
    ta, tb = T(a), T(b)
    want = {
        "add": lambda: jnp.add(a, b), "sub": lambda: jnp.subtract(a, b),
        "mul": lambda: jnp.multiply(a, b), "neg": lambda: jnp.negative(a),
    }[op]()
    got = {"add": lambda: ta + tb, "sub": lambda: ta - tb, "mul": lambda: ta * tb,
           "neg": lambda: -ta}[op]()
    same(got, want)


@pytest.mark.parametrize("bits", [0, 1, 7, 16, 62, 63])
def test_shifts_and_pow2_ops(ab, bits):
    a, _ = ab
    ta = T(a)
    ja = jnp.asarray(a)
    same(tring.mul_pow2(ta, bits), jring.mul_pow2(ja, bits))
    same(tring.shift_right_logical(ta, bits), jring.shift_right_logical(ja, bits))
    same(tring.shift_right_arith(ta, bits), jring.shift_right_arith(ja, bits))
    same(tring.trunc_div_pow2_signed(ta, bits), jring.trunc_div_pow2_signed(ja, bits))
    same(tring.floormod_pow2(ta, bits), jring.floormod_pow2(ja, bits))
    same(tring.signed_floordiv_pow2(ta, bits), jring.signed_floordiv_pow2(ja, bits))


@pytest.mark.parametrize("divisor", [3, 768, 1000, 65536])
def test_trunc_div_signed(ab, divisor):
    a, _ = ab
    same(tring.trunc_div_signed(T(a), divisor), jring.trunc_div_signed(jnp.asarray(a), divisor))


def test_scalar_and_to_ring():
    for v in (0, 1, -1, 1 << 63, (1 << 64) - 1, 12345 << 40, -(1 << 63)):
        assert np.int64(tring.scalar(v)).view(np.uint64) == jring.scalar(v)
    a = np.array([1, (1 << 64) - 2], dtype=np.uint64)
    same(tring.to_ring(a), jring.to_ring(jnp.asarray(a)))
    same(tring.to_ring(np.array([-3, 4], dtype=np.int32)), jring.to_ring(np.array([-3, 4], np.int32)))


def test_balanced_limbs_and_combine(ab):
    a, _ = ab
    got = tring._balanced_limbs(T(a))
    want = jring._balanced_limbs(jnp.asarray(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(5)
    planes = rng.integers(-(2 ** 31), 2 ** 31, size=(6, 8, 8), dtype=np.int64)
    same(tring._combine_planes(torch.from_numpy(planes)),
         jring._combine_planes(jnp.asarray(planes.astype(np.int32))))


MATMUL_CASES = {
    "ragged": ((5, 37), (37, 3)),
    "batched": ((3, 4, 9), (3, 9, 6)),
    "shared_2d_operand": ((2, 3, 4, 9), (9, 5)),
    "shared_left_operand": ((4, 9), (2, 9, 5)),
    "broadcast_batch": ((2, 1, 4, 9), (3, 9, 5)),
    "vector": ((9,), (9, 4)),
    "k_at_limit": ((1, (1 << 17) - 1), ((1 << 17) - 1, 1)),
}


@pytest.mark.parametrize("case", sorted(MATMUL_CASES))
def test_matmul_bit_exact(case):
    sa, sb = MATMUL_CASES[case]
    rng = np.random.default_rng(len(case))
    a, b = u64(rng, sa), u64(rng, sb)
    if case == "broadcast_batch":
        want = jring.matmul(jnp.broadcast_to(a, (2, 3, 4, 9)), jnp.broadcast_to(b, (2, 3, 9, 5)))
    else:
        want = jring.matmul(jnp.asarray(a), jnp.asarray(b))
    same(tring.matmul(T(a), T(b)), want)


def test_plain_matmul_agrees_with_int64_matmul():
    """On the CPU torch's int64 matmul is a second exact mod-2^64 oracle."""
    rng = np.random.default_rng(9)
    a, b = T(u64(rng, (3, 7, 33))), T(u64(rng, (3, 33, 10)))
    assert torch.equal(tring._plain_matmul(a, b), torch.matmul(a, b))
    # K above MAX_EXACT_K takes the split of the limb path
    k = tring.MAX_EXACT_K + 3
    a, b = T(u64(rng, (1, k))), T(u64(rng, (k, 2)))
    assert torch.equal(tring._plain_matmul(a, b), torch.matmul(a, b))


@pytest.mark.parametrize("n_pairs", [2, 3])
def test_matmul_acc_bit_exact(n_pairs):
    rng = np.random.default_rng(100 + n_pairs)
    pairs = [(u64(rng, (6, 21)), u64(rng, (21, 5))) for _ in range(n_pairs)]
    want = jring.matmul_acc([(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs])
    same(tring.matmul_acc([(T(a), T(b)) for a, b in pairs]), want)


@pytest.mark.parametrize("M,K,N", [(4, 16, 8), (65, 70, 30)])
def test_plain_ring_mm_matches_pallas_interpret(M, K, N):
    rng = np.random.default_rng(42 + M)
    a, b = u64(rng, (M, K)), u64(rng, (K, N))
    got = ring_mm.plain([(T(a)[None], T(b)[None])])[0]
    same(got, pmm.matmul_3d(jnp.asarray(a)[None], jnp.asarray(b)[None], interpret=True)[0])


def test_plain_ring_mm_acc_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    pairs = [(u64(rng, (4, 16)), u64(rng, (16, 8))) for _ in range(2)]
    want = pmm.matmul_acc([(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs], interpret=True)
    same(ring_mm.plain([(T(a), T(b)) for a, b in pairs]), want)


# -- encoder ------------------------------------------------------------------

@pytest.mark.parametrize("bits", [0, 16])
def test_encoder_bit_exact(bits):
    ct.init(world_size=2, seed=0, device="cpu")
    rng = np.random.default_rng(bits)
    xs = np.concatenate([rng.normal(size=50) * 1000, [0.0, -0.5, 0.5, -1e-7, 3.99999]])
    je, te = jenc.FixedPointEncoder(bits), tenc.FixedPointEncoder(bits)
    same(te.encode(torch.from_numpy(xs)), je.encode(xs))
    ints = rng.integers(-(2 ** 40), 2 ** 40, size=20)
    same(te.encode(torch.from_numpy(ints)), je.encode(ints))
    for s in (2.75, -3, 7):
        assert np.int64(te.encode(s)).view(np.uint64) == je.encode(s)
    ring_vals = u64(rng, (30,))
    np.testing.assert_array_equal(te.decode(T(ring_vals)), je.decode(ring_vals))


def test_nearest_integer_division():
    t = np.arange(-50, 51, dtype=np.int64)
    for d in (1, 2, 3, 7):
        np.testing.assert_array_equal(
            tenc.nearest_integer_division(t, d), jenc.nearest_integer_division(t, d)
        )
