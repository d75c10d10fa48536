"""The fused chains of the port: exp's squarings in one fused_mul pass, and
scan_reduction's chunk folds and butterfly tails in one max_step pass
(kernels/fused_mul.py, kernels/max_step.py).

* Each chain's plain version equals the per-step plain calls it replaces,
  bit for bit, step s at draw count count + s: at tiny sizes, an odd n, a
  broadcast operand and a row count that does not pair.
* At the MPC level (the plain versions on the CPU) a chain takes the draw
  counts, rounds and bytes of the per-step calls it replaces, and its shares
  equal theirs bit for bit.
* exp through the chain decodes as curl_tpu's exp on the same input
  (scan_reduction through the chains is held to curl_tpu by
  tests/test_torch_fused.py).
* The wrappers refuse CPU tensors and bad chains; on a card (marked
  ``cuda``) each chain's kernel equals its plain version.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import curl_tpu  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import random as crandom  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.kernels import fused_mul as fm  # noqa: E402
from curl_tpu_torch.kernels import max_step as ms  # noqa: E402
from curl_tpu_torch.kernels.keys import hold  # noqa: E402

KEY, = hold((0x0123_4567_89AB_CDEF,))  # the fused key, in a key-table slot
KNOBS = {"mpc.fused_mul": "cuda", "mpc.fused_trunc": "cuda",
         "mpc.fused_compare": "cuda", "mpc.fused_max_step": "cuda"}
SCAN = dict(KNOBS, **{"functions.max_method": "scan_reduction",
                      "functions.scan_fixed_width": 64, "functions.scan_cascade_min": 8,
                      "functions.scan_cascade_factor": 2})


def _shares(shape, seed=0, bits=20):
    """(2, *shape) int64 shares of values below 2^bits in magnitude."""
    g = np.random.default_rng(seed)
    v = g.integers(-(1 << bits), 1 << bits, size=shape)
    s1 = g.integers(-(1 << 62), 1 << 62, size=shape)
    return torch.from_numpy(np.stack([v - s1, s1]).astype(np.int64))


def _operand(layout):
    """A (2, ...) share in one of the chains' test layouts."""
    if layout == "odd":
        return _shares((5, 7))
    if layout == "broadcast":  # a stride-0 dim, read in place
        return _shares((3, 1, 8)).expand(2, 3, 4, 8)
    return _shares((4, 8))


# ---------------------------------------------------------------------------
# each chain's plain version against the per-step plain calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["contiguous", "odd", "broadcast"])
@pytest.mark.parametrize("chain", ["square", "fold", "butterfly"])
def test_chain_plain_equals_per_step_plain(chain, layout):
    x = _operand(layout)
    count = 40
    if chain == "square":
        got = fm.plain_square_chain("crypten", 16, x, 3, KEY, count)
        want = x
        for s in range(3):
            want = fm.plain("square", "crypten", 16, want, None, KEY, count + s)
    elif chain == "fold":  # the chunks are the next-to-last dim
        got = ms.plain_fold_chain(x, KEY, count)
        want = x.select(-2, 0)
        for g in range(1, x.shape[-2]):
            want = ms.plain_max_step(want, x.select(-2, g), KEY, count + g - 1)
    else:
        w = x.shape[-1]
        got = ms.plain_butterfly_chain(x, 3, KEY, count)
        want = x
        for i in range(3):
            want = ms.plain_max_step(want, want.roll(-(w >> (i + 1)), dims=-1), KEY, count + i)
    assert torch.equal(got, want)


def test_butterfly_rows_pair_only_when_even():
    """Word k holds elements k and k + n/2: rows rho and rho + R/2 of one
    column only when the rows R and the width are even."""
    assert ms.butterfly_pairs((12, 64, 64)) and ms.butterfly_pairs((64, 128))
    assert not ms.butterfly_pairs((3, 64))        # rows that do not pair
    assert not ms.butterfly_pairs((4, 7))         # an odd width
    assert not ms.butterfly_pairs((2, 2 * ms.MAX_BUTTERFLY_WIDTH))


def test_chain_values_are_the_max():
    """The fold leaves the max over the chunks, the butterfly the max of
    each row in lane 0."""
    x = _shares((3, 4, 8), seed=3)
    fold = ms.plain_fold_chain(x, KEY, 0)
    assert torch.equal(fold.sum(0), x.sum(0).max(dim=-2).values)
    tail = ms.plain_butterfly_chain(fold, 3, KEY, 9)
    assert torch.equal(tail.sum(0)[:, 0], fold.sum(0).max(dim=-1).values)


# ---------------------------------------------------------------------------
# MPC level: a chain's counts, CommStats and shares equal the per-step path's
# ---------------------------------------------------------------------------

def _per_step_square_chain(x, steps, m):
    for _ in range(steps):
        x = fm.fused_square_mpc(x, "crypten", m)
    return x


def _per_step_fold(chunked):
    d = chunked.dim()
    carry = chunked.narrow(d - 2, 0, 1).squeeze(d - 2)
    for g in range(1, chunked.size(d - 2)):
        carry = ms.fused_max_step_mpc(carry, chunked.narrow(d - 2, g, 1).squeeze(d - 2))
    return carry


def _per_step_butterfly(x, steps):
    w = x.size(x.dim() - 1)
    for i in range(steps):
        x = ms.fused_max_step_mpc(x, x.roll(-(w >> (i + 1)), dims=x.dim() - 1))
    return x


_X = np.random.default_rng(8).normal(size=(4, 300)) * 2  # 1200 elements: the fused gates open
MPC_CASES = {
    # name: (input, op, the entry points swapped for their per-step paths)
    "exp": (_X / 4, lambda a: a.exp(),
            [(fm, "fused_square_chain_mpc", _per_step_square_chain)]),
    "max": (_X, lambda a: a.max_value(-1),
            [(ms, "fused_fold_chain_mpc", _per_step_fold),
             (ms, "fused_butterfly_chain_mpc", _per_step_butterfly)]),
}


def _mpc_run(name, per_step, monkeypatch):
    v, op, swaps = MPC_CASES[name]
    ct.init(world_size=2, seed=21, device="cpu")
    x = ct.cryptensor(v)
    counts = []
    orig = fm.plain, ms.plain_max_step
    with monkeypatch.context() as mp:
        # every plain step records its draw count
        mp.setattr(fm, "plain", lambda *a: counts.append(a[-1]) or orig[0](*a))
        mp.setattr(ms, "plain_max_step", lambda *a: counts.append(a[-1]) or orig[1](*a))
        if per_step:
            for mod, name_, fn in swaps:
                mp.setattr(mod, name_, fn)
        with cfg.temp_override(SCAN):
            ct.reset_communication_stats()
            out = op(x)
            stats = ct.get_communication_stats()
    return out.share, stats, counts, crandom._next_count()


@pytest.mark.parametrize("name", sorted(MPC_CASES))
def test_chain_mpc_equals_per_step_mpc(name, monkeypatch):
    """Shares bit for bit, the draw counts each step took, the counter after
    the call, and CommStats."""
    share, stats, counts, after = _mpc_run(name, False, monkeypatch)
    ref_share, ref_stats, ref_counts, ref_after = _mpc_run(name, True, monkeypatch)
    assert counts == ref_counts and after == ref_after
    assert len(counts) == {"exp": 8, "max": 13}[name]
    assert stats == ref_stats
    assert torch.equal(share, ref_share)


def test_exp_chain_decodes_like_curl_tpu():
    """exp of 1024 elements (the fused gate's least) through the chain, and
    curl_tpu's exp on the same input, with the same rounds and bytes. Each
    squaring's local truncation errs by a unit of 2^-16 a share, and the
    later squarings scale what came before, so the two packages differ
    relatively (up to 0.7% at x = 3, where e^x = 20): rtol 0.02."""
    v = np.linspace(-3.0, 3.0, 1024).reshape(32, 32)
    ct.init(world_size=2, seed=1234, device="cpu")
    with cfg.temp_override(KNOBS):
        ct.reset_communication_stats()
        got = ct.cryptensor(v).exp()
        stats = ct.get_communication_stats()
    curl_tpu.init(world_size=2, seed=1234)
    from curl_tpu import comm as jcomm

    jx = curl_tpu.cryptensor(v)
    with curl_tpu.no_grad():
        jcomm.reset_communication_stats()
        want = jx.exp().get_plain_text()
        jstats = jcomm.get_communication_stats()
    np.testing.assert_allclose(got.get_plain_text(), want, atol=0.01, rtol=0.02)
    assert (stats["rounds"], stats["bytes"]) == (jstats["rounds"], jstats["bytes"])


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def test_chain_wrappers_refuse_cpu_tensors_and_bad_chains():
    x = _shares((4, 8))
    for call in (lambda: fm.launch_square_chain("crypten", 16, x, 8, KEY, 0),
                 lambda: ms.launch_fold_chain(x.reshape(2, 4, 2, 4), KEY, 0),
                 lambda: ms.launch_butterfly_chain(x, 3, KEY, 0),
                 lambda: fm.plain_square_chain("crypten", 16, x, 0, KEY, 0),
                 lambda: fm.plain_square_chain("crypten", 16, x, 2, KEY, (1 << 48) - 1),
                 lambda: fm.launch("mul", "egk", 16, x, x, KEY, 0, steps=2),
                 lambda: ms.plain_fold_chain(x.reshape(2, 1, 32), KEY, 0),  # one chunk
                 lambda: ms.plain_butterfly_chain(x, 0, KEY, 0)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.cuda
def test_chain_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    g = torch.Generator().manual_seed(2)
    r = lambda *s: torch.randint(-(2 ** 40), 2 ** 40, s, generator=g).cuda()  # noqa: E731
    for x in (r(2, 1031), r(2, 33, 64), r(2, 7, 150).transpose(1, 2)):
        assert torch.equal(fm.launch_square_chain("crypten", 16, x, 8, KEY, 5),
                           fm.plain_square_chain("crypten", 16, x, 8, KEY, 5))
    for chunked in (r(2, 3, 5, 64), r(2, 64, 4, 128)[:, :, :, :64], r(2, 7, 2, 33)):
        assert torch.equal(ms.launch_fold_chain(chunked, KEY, 7),
                           ms.plain_fold_chain(chunked, KEY, 7))
    for x in (r(2, 12, 64, 64), r(2, 64, 128), r(2, 10, 8), r(2, 3, 64)):
        steps = int(np.log2(x.shape[-1]))
        assert torch.equal(ms.launch_butterfly_chain(x, steps, KEY, 11),
                           ms.plain_butterfly_chain(x, steps, KEY, 11))
