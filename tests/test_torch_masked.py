"""The port's Beaver-masked operand reuse (``beaver.mask_operand``,
``MaskedArithmetic``) against curl_tpu's, on the CPU.

Counterpart of tests/test_masked_operand.py at its sizes. curl_tpu's
compiled batch-2 GPT there takes minutes on a CPU, so the port's batch-2
GPT is held to a float64 forward of the same weights instead, and
curl_tpu's masked product is traced (``jax.make_jaxpr``) for its CommStats
rather than run.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import curl_tpu  # noqa: E402
from curl_tpu import comm as jcomm  # noqa: E402
from curl_tpu import ring as jring  # noqa: E402
from curl_tpu.mpc.primitives import beaver as jbeaver  # noqa: E402
from curl_tpu.parallel import compile_parties as jcompile  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import ring  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.kernels import ring_mm  # noqa: E402
from curl_tpu_torch.mpc.primitives import beaver  # noqa: E402
from curl_tpu_torch.mpc.primitives.arithmetic import ArithmeticSharedTensor  # noqa: E402

_g = np.random.default_rng(0)
W = _g.normal(size=(6, 5))
XS = [_g.normal(size=(4, 6)) for _ in range(3)]


@pytest.fixture(autouse=True)
def _init():
    ct.init(world_size=2, seed=13, device="cpu")


def _masked(value):
    m = beaver.mask_operand(ct.cryptensor(value)._tensor)
    assert type(m) is beaver.MaskedArithmetic
    return m


def test_masked_matmul_and_mul_decode_and_reuse():
    masked = _masked(W)
    row = _masked(W[0])
    for x in XS:
        out = beaver.matmul(ct.cryptensor(x)._tensor, masked).get_plain_text()
        # products of two 2^16 encodings, no rescale at the protocol layer
        # (test_masked_operand.py:38-40)
        np.testing.assert_allclose(out, (x @ W) * (1 << 16), rtol=1e-4, atol=16.0)
        out = beaver.mul(ct.cryptensor(x[:, :5])._tensor, row).get_plain_text()
        np.testing.assert_allclose(out, x[:, :5] * W[0] * (1 << 16), rtol=1e-4, atol=16.0)
    # through the arithmetic layer, rescaled, and with the transposed view
    xe = ct.cryptensor(XS[0])
    got = xe._tensor.matmul(_masked(W.T).t()).get_plain_text()
    np.testing.assert_allclose(got, XS[0] @ W, atol=2e-3)


def test_masked_share_reconstructs_the_operand():
    masked = _masked(W)
    np.testing.assert_allclose(masked.get_plain_text(), W, atol=1e-4)
    doubled = masked.with_share(masked.share + masked.share)
    assert type(doubled) is ArithmeticSharedTensor
    np.testing.assert_allclose(doubled.get_plain_text(), 2 * W, atol=1e-3)
    # the views keep the mask: t(), transpose and the scale-1 view
    assert type(masked.t()) is beaver.MaskedArithmetic
    assert masked.t().shape == (5, 6)
    np.testing.assert_allclose(masked.transpose(0, 1).get_plain_text(), W.T, atol=1e-4)
    assert type(beaver._raw(masked)) is beaver.MaskedArithmetic


@pytest.mark.parametrize("masked_mode", [True, False])
def test_masked_embedding_lookup(masked_mode):
    rng = np.random.default_rng(4)
    table = rng.normal(size=(32, 6))
    ids = np.array([0, 3, 31, 17, 5], dtype=np.float64)
    te = ct.cryptensor(table)
    t = beaver.mask_operand(te._tensor) if masked_mode else te._tensor
    assert (type(t) is beaver.MaskedArithmetic) == masked_mode
    out = ct.cryptensor(ids, precision=0)._tensor.evaluate_embed(t)
    np.testing.assert_allclose(out.get_plain_text(), table[ids.astype(int)], atol=2e-4)


@pytest.mark.parametrize("shape", [(4, 6, 5), (2, 50257, 3)], ids=["small", "K50257"])
def test_masked_matmul_is_one_three_pair_launch_equal_to_curl_tpus_summed_products(
        shape, monkeypatch):
    """The masked matmul makes one ring_mm_acc call of three pairs; its
    result equals, bit for bit, the three products summed by curl_tpu's
    ring (which sums them where 3 K >= 2^17, ring.py:319)."""
    m, k, n = shape
    rng = np.random.default_rng(1)
    x, w = rng.normal(size=(m, k)), rng.normal(size=(k, n)) * 0.1
    calls = []
    acc = ring.matmul_acc
    monkeypatch.setattr(ring, "matmul_acc", lambda pairs: calls.append(list(pairs)) or acc(pairs))
    masked = _masked(w)
    z = beaver.matmul(ct.cryptensor(x)._tensor, masked)
    (pairs,) = calls
    assert len(pairs) == 3
    fused = ring_mm.plain(pairs)
    summed = 0
    for a, b in pairs:
        jb = jring.to_ring(np.broadcast_to(ring.to_numpy_u64(b), np.broadcast_shapes(
            b.shape[:-2], a.shape[:-2]) + tuple(b.shape[-2:])))
        summed = summed + np.asarray(jring.matmul(jring.to_ring(ring.to_numpy_u64(a)), jb))
    np.testing.assert_array_equal(ring.to_numpy_u64(fused), summed)
    np.testing.assert_allclose(z.get_plain_text(), (x @ w) * (1 << 16), rtol=1e-4,
                               atol=16.0 * max(1, k // 64))


def test_masked_product_comm_stats_equal_curl_tpus():
    """Masking once (one delta reveal of w's size), then three products
    (one eps reveal each): rounds, bytes and calls equal curl_tpu's,
    counted at trace."""

    def fn(w, *xs):
        masked = jbeaver.mask_operand(w._tensor)
        return [x._wrap(jbeaver.matmul(x._tensor, masked)) for x in xs]

    curl_tpu.init(world_size=2, seed=13)
    jcomm.reset_communication_stats()
    jax.make_jaxpr(jcompile(fn, 2))(jax.random.PRNGKey(5), curl_tpu.cryptensor(W).mpc,
                                    *[curl_tpu.cryptensor(x).mpc for x in XS])
    want = jcomm.get_communication_stats()

    ct.reset_communication_stats()
    masked = _masked(W)
    for x in XS:
        beaver.matmul(ct.cryptensor(x)._tensor, masked)
    got = ct.get_communication_stats()
    assert (got["rounds"], got["bytes"], got["calls"]) == (want["rounds"], want["bytes"],
                                                            dict(want["calls"]))
    assert got["rounds"] == 4 and got["bytes"] == (W.size + sum(x.size for x in XS)) * 8


def test_mask_operand_declines_under_active_security():
    y = ct.cryptensor(W)._tensor
    with cfg.temp_override({"mpc.active_security": True}):
        assert beaver.mask_operand(y) is y
    assert type(beaver.mask_operand(y)) is beaver.MaskedArithmetic


def test_batch2_gpt_chunked_head_premasks_and_decodes(monkeypatch):
    """Batch 2 with models.head_chunk_positions 8 (test_masked_operand.py
    :90-111's sizes and bound): the embedding table and the LM head are
    masked once each (two delta reveals), and the probabilities decode
    within 0.08 of a float64 forward of the same weights."""
    from chip_smoke import random_gpt2_state
    from curl_tpu_torch.models import GPT, load_numpy_state_dict
    from curl_tpu_torch.models.generate import plaintext_logits

    ct.init(world_size=2, seed=31, device="cpu")
    sd = random_gpt2_state(np.random.default_rng(31), 8, 1, d=16, vocab=40)
    x = (np.arange(16, dtype=np.float64).reshape(2, 8) * 3) % 40
    logits = plaintext_logits(sd, np.eye(40)[x.astype(int)], 2, causal=False)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    plain = e / e.sum(-1, keepdims=True)
    m = load_numpy_state_dict(GPT(16, 2, 1, 40, 8), sd).encrypt(src=0)
    apply_fn, params = m.functional()
    masks = []
    mask_operand = beaver.mask_operand
    monkeypatch.setattr(beaver, "mask_operand", lambda y: masks.append(y.shape) or mask_operand(y))
    with cfg.temp_override({"models.head_chunk_positions": 8,
                            "functions.max_method": "scan_reduction"}):
        ct.reset_communication_stats()
        got = apply_fn(params, ct.cryptensor(x, precision=0)).get_plain_text()
        stats = ct.get_communication_stats()
    assert masks == [(40, 16), (40, 16)]  # the table, then the head's weight
    assert type(m.tok_embed.weight._tensor) is beaver.MaskedArithmetic
    assert type(m.fc.weight._tensor) is beaver.MaskedArithmetic
    # a rebinding restores the plain shares: the next call masks anew
    m.bind_params(params)
    assert type(m.fc.weight._tensor) is ArithmeticSharedTensor
    assert got.shape == plain.shape == (2, 8, 40)
    assert np.abs(got - plain).max() < 0.08
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=0.08)
    assert stats["calls"]["all_sum"] > 2
