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
    )
    for pairs in cases:
        assert torch.equal(ring_mm.ring_mm(pairs), ring_mm.plain(pairs))


def test_philox_refuses_bad_arguments():
    with pytest.raises(ValueError):
        philox.plain_philox("share", [1, 2], 0, 4, plain=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        philox.plain_philox("draw", [1] * 9, 0, 4, device="cpu")


@pytest.mark.cuda
def test_philox_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    keys = [3, 5]
    plain = torch.arange(1001, dtype=torch.int64, device="cuda")
    for mode, kw in (("draw", {"kbits": 17}), ("przs", {}), ("share", {"plain": plain}),
                     ("share_lane", {"plain": torch.stack([plain, -plain]), "src": 1})):
        got = philox.philox(mode, keys, 4, 1001, device="cuda", **kw)
        assert torch.equal(got, philox.plain_philox(mode, keys, 4, 1001, device="cuda", **kw))
