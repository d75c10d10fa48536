"""The CUDA kernels' wrappers, and the kernels against their plain versions.

This file imports only torch and curl_tpu_torch, so it also runs on a
machine with a CUDA card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py

Without a card the tests marked ``cuda`` skip (a CUDA kernel has no CPU
mode) and the wrappers' argument checks and stride logic still run.
"""

import pytest
import torch

from curl_tpu_torch.kernels import philox, ring_mm


def test_batch_strides_keep_shared_operands_in_place():
    w = torch.zeros(9, 5, dtype=torch.int64)
    assert ring_mm._batch_strides(w, (2, 3)) == (0, 0)
    eps = torch.zeros(1, 12, 4, 4, dtype=torch.int64)  # public, party axis broadcast
    assert ring_mm._batch_strides(eps, (2, 1, 12)) == (0, 16)
    x = torch.zeros(2, 1, 12, 4, 4, dtype=torch.int64)
    assert ring_mm._batch_strides(x, (2, 1, 12)) == (192, 16)
    # an inner broadcast that one stride cannot describe is copied
    y = torch.zeros(2, 3, 1, 4, 4, dtype=torch.int64)
    assert ring_mm._batch_strides(y, (2, 3, 5)) is None


def test_ring_mm_refuses_cpu_tensors():
    a = torch.zeros(2, 3, dtype=torch.int64)
    with pytest.raises(ValueError):
        ring_mm.ring_mm([(a, a.T)])


@pytest.mark.cuda
def test_ring_mm_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randint(-(2 ** 62), 2 ** 62, s, generator=g).cuda()  # noqa: E731
    cases = (
        [(r(2, 65, 130), r(130, 70))],
        [(r(1, 8, 33), r(2, 1, 33, 9)), (r(2, 1, 8, 33), r(33, 9))],
        # the path's layouts: a transposed weight, attention's permuted keys
        [(r(1, 8, 33), r(2, 1, 33, 9)), (r(2, 1, 8, 33), r(9, 33).t())],
        [(r(2, 1, 3, 7, 5), r(2, 1, 7, 3, 5).permute(0, 1, 3, 4, 2))],
        # K past one FLUSH_K chunk, and four pairs of odd K
        [(r(3, 8193), r(8193, 5))],
        [(r(3, k), r(k, 5)) for k in (8193, 100, 4000, 37)],
    )
    # operands whose balanced digits are extreme (0x80..80: -128, then -127
    # in every limb), at K around FLUSH_K and at a width whose 132 blocks
    # each contract one whole FLUSH_K chunk
    full = lambda v, *s: torch.full(s, v, dtype=torch.int64, device="cuda")  # noqa: E731
    extremes = (-(2 ** 63), -1, 0x7F7F7F7F7F7F7F7F, 0x8080808080808080 - 2 ** 64)
    cases += tuple([(full(v, 3, k), full(v, k, 5))] for v in extremes for k in (8191, 8192, 8193))
    cases += tuple([(full(v, 64, 8192), full(v, 8192, 132 * 64))] for v in extremes[2:])
    for pairs in cases:
        assert torch.equal(ring_mm.ring_mm(pairs), ring_mm.plain(pairs))


@pytest.mark.cuda
def test_ring_mm_three_pairs_match_plain_on_card():
    """A Beaver-masked product's launch: three pairs (party 0's dealer
    product, eps @ b_share, x @ delta), at the generator's embedding K =
    50257 with a transposed delta, and at odd K."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randint(-(2 ** 62), 2 ** 62, s, generator=g).cuda()  # noqa: E731
    for m, k, n in ((64, 50257, 768), (3, 8193, 5), (65, 131, 67), (2, 50257, 3)):
        a_eff = torch.stack([r(1, m, k)[0], torch.zeros(m, k, dtype=torch.int64, device="cuda")])
        pairs = [(a_eff, r(k, n)), (r(m, k), r(2, k, n)), (r(2, m, k), r(n, k).t())]
        assert torch.equal(ring_mm.ring_mm(pairs), ring_mm.plain(pairs)), (m, k, n)


def test_philox_refuses_bad_arguments():
    with pytest.raises(ValueError):
        philox.plain_philox("share", [1, 2], 0, 4, plain=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        philox.plain_philox("draw", [1] * 9, 0, 4, device="cpu")


@pytest.mark.cuda
def test_philox_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from curl_tpu_torch.kernels.keys import hold

    keys = [3, 5]
    # the segments' keys, in slots of one key table
    ref, k11, k1_8, k357, k13 = hold(keys, (11,), tuple(range(1, 9)), (3, 5, 7), (13,))
    plain = torch.arange(1001, dtype=torch.int64, device="cuda")
    for mode, kw in (("draw", {"kbits": 17}), ("przs", {}), ("share", {"plain": plain}),
                     ("share_lane", {"plain": torch.stack([plain, -plain]), "src": 1})):
        got = philox.philox(mode, ref, 4, 1001, device="cuda", **kw)
        assert torch.equal(got, philox.plain_philox(mode, keys, 4, 1001, device="cuda", **kw))
    # one grouped launch of mixed segments: every kind, additive and XOR,
    # odd n, n = 1, rows 1-8, emitted draws
    lane = torch.stack([plain, -plain, plain + 7])
    S = philox.Segment
    segments = [
        S("draw", k11, 1, 1), S("draw", k1_8, 2, 1001, kbits=20),
        S("zero", ref, 3, 1001), S("zero", k357, 4, 999, how="xor", kbits=1),
        S("plain", ref, 5, 1001, plain=plain, src=1),
        S("plain", ref, 6, 1001, how="xor", plain=plain),
        S("plain_lane", k357, 7, 1001, plain=lane, src=2),
        S("plain_lane", k357, 8, 1001, how="xor", kbits=64, plain=lane, src=1),
        S("fresh", ref, 9, 1001, dealer=k13, draw_counter=1, emit=True),
        S("fresh", ref, 10, 1, dealer=k13, draw_counter=2, draw_kbits=1),
        S("fresh", ref, 11, 1001, how="xor", dealer=k13, draw_counter=2, draw_kbits=1),
        S("fresh", k1_8, 12, 257, dealer=k13, draw_counter=3, draw_kbits=48, emit=True),
    ]
    got = philox.philox_group(segments, "cuda")
    for seg, a, b in zip(segments, got, philox.plain_philox_group(segments, "cuda")):
        a, b = (a, b) if seg.emit else ((a,), (b,))  # emitted: (shares, value)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), seg.signature()


def test_fused_kernels_refuse_cpu_tensors_and_bad_arguments():
    from curl_tpu_torch.kernels import fused_mul, max_step
    from curl_tpu_torch.kernels.keys import hold

    x = torch.zeros(2, 8, dtype=torch.int64)
    k, two = hold((1,), (1, 2))
    with pytest.raises(ValueError):
        fused_mul.launch("mul", "egk", 16, x, x, k, 0)
    with pytest.raises(ValueError):
        max_step.launch_ltz(x, k, 0)
    with pytest.raises(ValueError):
        max_step.launch_max_step(x, x, k, 0)
    bad = (
        lambda: fused_mul.plain("cube", "egk", 16, x, None, k, 0),   # unknown op
        lambda: fused_mul.plain("mul", "egk", 16, x, None, k, 0),    # mul without y
        lambda: fused_mul.plain("trunc", "none", 0, x, None, k, 0),  # trunc is EGK alone
        lambda: fused_mul.plain("square", "egk", 62, x, None, k, 0),  # m outside 0..61
        lambda: fused_mul.plain("square", "egk", 16, x, None, k, 1 << 48),  # count > 48 bits
        lambda: fused_mul.plain("square", "egk", 16, x[:1], None, k, 0),  # one party
        lambda: fused_mul.plain("square", "egk", 16, x, None, two, 0),  # a key of two slots
        lambda: max_step.plain_ltz(x.to(torch.int32), k, 0),
        lambda: max_step.plain_max_step(x, x, k, -1),
    )
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.cuda
def test_fused_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from curl_tpu_torch.kernels import fused_mul, max_step

    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randint(-(2 ** 40), 2 ** 40, s, generator=g).cuda()  # noqa: E731
    from curl_tpu_torch.kernels.keys import hold

    key, = hold((0x1234_5678_9ABC_DEF0,))
    # an odd n; a broadcast column (LayerNorm's rescale); a transposed x
    # read in place through its strides
    for x, y in ((r(2, 1031), r(2, 1031)), (r(2, 33, 65), r(2, 33, 1)),
                 (r(2, 150, 7).transpose(1, 2), r(2, 150))):
        for op, trunc, m in (("mul", "egk", 16), ("mul", "none", 0), ("mul", "crypten", 16),
                             ("square", "crypten", 16), ("square", "egk", 16),
                             ("trunc", "egk", 13)):
            args = (op, trunc, m, x, y if op == "mul" else None, key, 9)
            assert torch.equal(fused_mul.launch(*args), fused_mul.plain(*args)), (op, trunc)
        assert torch.equal(max_step.launch_ltz(x, key, 3), max_step.plain_ltz(x, key, 3))
        assert torch.equal(max_step.launch_max_step(x, y, key, 4),
                           max_step.plain_max_step(x, y, key, 4))


def test_seed_expand_refuses_cpu_tensors_and_bad_arguments():
    from curl_tpu_torch.kernels import seed_expand

    x = torch.zeros(4, 6, dtype=torch.int64)
    with pytest.raises(ValueError):
        seed_expand.launch_compress(x, 1)
    with pytest.raises(ValueError):
        seed_expand.launch_expand(x, 1)
    bad = (
        lambda: seed_expand.plain_compress(x.to(torch.int32), 1),  # dtype
        lambda: seed_expand.plain_expand(x.t(), 1),                # not contiguous
        lambda: seed_expand.plain_expand(x, 1, parties=3),         # 2PC or one party only
        lambda: seed_expand.plain_compress(x, 1 << 64),            # key beyond 64 bits
        lambda: seed_expand.plain_compress(x, -1),
    )
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.cuda
def test_seed_expand_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from curl_tpu_torch.kernels import seed_expand

    g = torch.Generator().manual_seed(2)
    key = 0xFEDC_BA98_7654_3210
    for shape in ((1,), (1031,), (33, 65), (2, 3, 4)):
        e = torch.randint(-(2 ** 62), 2 ** 62, shape, generator=g).cuda()
        share0 = seed_expand.launch_compress(e, key)
        assert torch.equal(share0, seed_expand.plain_compress(e, key))
        for parties in (1, 2):
            got = seed_expand.launch_expand(share0, key, parties)
            assert torch.equal(got, seed_expand.plain_expand(share0, key, parties))
            assert torch.equal(got.sum(0), e)
