"""The Beaver open of a seed-compressed operand (kernels/seed_expand.py
``open``, mpc/primitives/compressed.py's views, beaver.py's open route).

A Beaver matmul whose y is seed-compressed (2 parties, the TFP dealer)
never expands y: ``t()``, ``transpose(-1, -2)`` and ``_raw`` keep it
compressed, and delta = y - b is opened in one pass from share0, the key
and b's shares. These tests hold that route to the composable one it
replaces, bit for bit at the same draw counters: the same compressed
tensor's expansion wrapped as a plain ArithmeticSharedTensor, which takes
the composable Beaver product. Rounds, bytes and calls must be equal too.

* ``plain_open`` against the composable open, at odd and transposed
  shapes and through b's strides;
* a Beaver matmul, ChunkedLinear on both axes, a weight used twice, and a
  tiny compressed GPT forward, each against the composable route;
* the compressed views expand nothing;
* the wrappers refuse what the kernel does not take; on a card (marked
  ``cuda``) the kernel equals its plain version, and so do both of ltz's
  designs.

curl_tpu is not run here: tests/test_torch_compressed.py holds the chunked
linear, the embedding, the LM head and the CommStats of the compressed GPT
(all of which now take the open route) to the JAX package.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import random as crandom  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.kernels import max_step, seed_expand  # noqa: E402
from curl_tpu_torch.kernels.philox import stream  # noqa: E402
from curl_tpu_torch.models import GPT  # noqa: E402
from curl_tpu_torch.mpc.mpc import MPCTensor  # noqa: E402
from curl_tpu_torch.mpc.primitives import beaver  # noqa: E402
from curl_tpu_torch.mpc.primitives.arithmetic import ArithmeticSharedTensor  # noqa: E402
from curl_tpu_torch.mpc.primitives.compressed import SeedCompressedArithmetic  # noqa: E402
from curl_tpu_torch.nn.module import ChunkedLinear, Module, scan_chunked  # noqa: E402

KEY = 0x0DDB_A11C_0FFE_E5ED
GEOM = dict(embed_dim=16, num_heads=2, num_blocks=2, vocab_size=50, seq_len=8)
TOKENS = np.arange(8).reshape(1, 8) * 7 % 50


def _i64(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(-2 ** 63, 2 ** 63 - 1, size=shape))


def _composable_open(share0, key, transposed, b_share):
    """delta as the composable route opens it: the expansion's view less b,
    then the reveal's sum over the parties."""
    y = seed_expand.plain_expand(share0, key)
    if transposed:
        y = y.transpose(-1, -2)
    diff = y - b_share
    return diff[0] + diff[1]


def _expanded(t):
    """A compressed MPCTensor's expansion as a plain one (the composable
    route); anything else as it is."""
    inner = t._tensor if isinstance(t, MPCTensor) else None
    if isinstance(inner, SeedCompressedArithmetic):
        return MPCTensor(ArithmeticSharedTensor(inner.share, inner.encoder))
    return t


def _expand_params(model):
    """Swap every compressed parameter of ``model`` for its expansion."""
    for m in model.modules():
        if isinstance(m, Module):
            for name, p in list(m._params.items()):
                m._params[name] = [_expanded(t) for t in p] if isinstance(p, list) else _expanded(p)


def _twice(fn, swap):
    """fn() by the open route, then swap() and fn() again from the same draw
    counter by the composable route: (shares, CommStats) of each."""
    out = []
    c0 = crandom._counter
    for i in range(2):
        if i:
            swap()
            crandom._counter = c0
        ct.reset_communication_stats()
        z = fn()
        out.append((z.share if hasattr(z, "share") else z._tensor.share,
                    ct.get_communication_stats()))
    return out


@pytest.fixture
def opens(monkeypatch):
    """Calls of seed_expand.open and of plain_expand, counted."""
    seen = {"open": 0, "expand": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(seed_expand, "open", counted("open", seed_expand.open))
    monkeypatch.setattr(seed_expand, "plain_expand", counted("expand", seed_expand.plain_expand))
    return seen


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

OPEN_CASES = {
    "embedding chunk, odd rows": ((13, 6), False),
    "transposed weight, odd in and out": ((7, 5), True),
    "transposed weight, odd in": ((6, 5), True),
    "transposed, batched": ((3, 5, 7), True),
    "untransposed, 1-D": ((9,), False),
}


@pytest.mark.parametrize("case,b_layout", [(c, "contiguous") for c in OPEN_CASES] + [
    (c, "transposed buffer") for c, (shape, _) in OPEN_CASES.items() if len(shape) >= 2])
def test_plain_open_equals_the_composable_open(case, b_layout):
    shape, transposed = OPEN_CASES[case]
    share0 = _i64(shape, 1)
    view = seed_expand.view_shape(share0, transposed)
    b = _i64((2,) + view, 2)
    if b_layout != "contiguous":
        b = _i64((2,) + view[:-2] + view[::-1][:2], 3).transpose(-1, -2)
    got = seed_expand.plain_open(share0, KEY, transposed, b)
    assert got.shape == view and got.is_contiguous()
    assert torch.equal(got, _composable_open(share0, KEY, transposed, b))
    assert torch.equal(seed_expand.open(share0, KEY, transposed, b), got)


def test_open_indexes_the_stream_by_the_stored_layout():
    """A transposed view's element (i, o) takes stream element o * in + i."""
    share0 = torch.zeros((3, 5), dtype=torch.int64)
    b = torch.zeros((2, 5, 3), dtype=torch.int64)
    want = stream(KEY, 0, 15, "cpu").reshape(3, 5).t()
    assert torch.equal(seed_expand.plain_open(share0, KEY, True, b), want)


def test_open_refuses_what_the_kernel_does_not_take():
    share0 = _i64((4, 3), 0)
    with pytest.raises(ValueError, match="shape"):
        seed_expand.plain_open(share0, KEY, True, _i64((2, 4, 3), 1))
    with pytest.raises(ValueError, match="contiguous"):
        seed_expand.plain_open(share0.t(), KEY, False, _i64((2, 3, 4), 1))
    with pytest.raises(ValueError, match="2 dims"):
        seed_expand.plain_open(_i64((4,), 0), KEY, True, _i64((2, 4), 1))
    with pytest.raises(ValueError, match="CUDA"):
        seed_expand.launch_open(share0, KEY, False, _i64((2, 4, 3), 1))


# ---------------------------------------------------------------------------
# the compressed views
# ---------------------------------------------------------------------------

def test_compressed_views_make_no_expansion(opens):
    ct.init(world_size=2, seed=1, device="cpu")
    w = SeedCompressedArithmetic.encrypt(np.arange(12.0).reshape(3, 4), KEY)
    views = {"t": w.t(), "transpose(-1, -2)": w.transpose(-1, -2),
             "transpose(1, 0)": w.transpose(1, 0), "t().t()": w.t().t(),
             "_raw": beaver._raw(w), "_raw(t())": beaver._raw(w.t()),
             "MPCTensor.t": MPCTensor(w).t()._tensor}
    assert opens == {"open": 0, "expand": 0}
    for name, v in views.items():
        assert isinstance(v, SeedCompressedArithmetic), name
        assert v.share0 is w.share0 and v.key == w.key, name
    assert views["t"].shape == (4, 3) and views["t().t()"].shape == (3, 4)
    assert views["_raw"].encoder.scale == 1 and views["t"].encoder is w.encoder
    # reading a view's share expands once, in share0's own layout
    assert torch.equal(views["t"].share, w.share.transpose(-1, -2))
    np.testing.assert_array_equal(views["t"].get_plain_text(), np.arange(12.0).reshape(3, 4).T)
    # a 1-D tensor is its own transpose
    v = SeedCompressedArithmetic.encrypt(np.ones(5), KEY)
    assert v.t() is v


# ---------------------------------------------------------------------------
# the open route against the composable route, at the same counters
# ---------------------------------------------------------------------------

def _beaver_case(name):
    """(x, y) of one Beaver matmul: x an MPCTensor, y a compressed view."""
    g = np.random.default_rng(7)
    if name == "linear, odd in and out":  # x @ W.t(), W (out 7, in 5)
        w = SeedCompressedArithmetic.encrypt(g.normal(size=(7, 5)), KEY)
        return ct.cryptensor(g.normal(size=(2, 3, 5))), MPCTensor(w).t()
    if name == "transpose(-1, -2)":
        w = SeedCompressedArithmetic.encrypt(g.normal(size=(6, 4)), KEY)
        return ct.cryptensor(g.normal(size=(3, 4))), MPCTensor(w).transpose(-1, -2)
    # the embedding: a one-hot slice @ an odd-row vocab chunk at scale 1
    w = SeedCompressedArithmetic.encrypt(g.normal(size=(13, 6)), KEY)
    onehot = np.eye(13)[g.integers(0, 13, size=5)]
    return (ct.cryptensor(onehot, precision=0),
            MPCTensor(beaver._raw(w)))


@pytest.mark.parametrize("name", ["linear, odd in and out", "transpose(-1, -2)",
                                  "embedding chunk at scale 1"])
def test_beaver_matmul_open_route_equals_composable(name, opens):
    ct.init(world_size=2, seed=4, device="cpu")
    x, y = _beaver_case(name)
    holder = {"y": y}

    def swap():
        holder["y"] = _expanded(holder["y"])

    (z1, s1), (z2, s2) = _twice(lambda: x.matmul(holder["y"]), swap)
    assert opens["open"] == 1
    assert torch.equal(z1, z2)
    assert s1 == s2 and s1["calls"]["all_sum"] >= 1


@pytest.mark.parametrize("axis", [0, 1])
def test_chunked_linear_open_route_equals_composable(axis, opens):
    g = np.random.default_rng(axis)
    w = torch.from_numpy(g.uniform(-0.5, 0.5, size=(11, 9)))  # odd in and out, padded chunks
    b = torch.from_numpy(g.uniform(-0.5, 0.5, size=11))
    ct.init(world_size=2, seed=6, device="cpu")
    lin = ChunkedLinear(w, b, 4, axis).encrypt()
    x = ct.cryptensor(g.normal(size=(2, 3, 9)))
    (z1, s1), (z2, s2) = _twice(lambda: lin(x), lambda: _expand_params(lin))
    assert opens["open"] == 4
    assert torch.equal(z1, z2) and s1 == s2
    np.testing.assert_allclose(ArithmeticSharedTensor(z1, x.encoder).get_plain_text(),
                               x.get_plain_text() @ w.numpy().T + b.numpy(), atol=4 * 2 ** -15)


def test_weight_used_twice_opens_each_use(opens):
    """The LM head over chunks of positions (head_chunk_positions): one
    compressed weight, one open per use, each with its own triple."""
    g = np.random.default_rng(3)
    ct.init(world_size=2, seed=8, device="cpu")
    head = ChunkedLinear(torch.from_numpy(g.normal(size=(10, 6))), None, 2, 0,
                         tag=crandom.HEAD).encrypt()
    x = ct.cryptensor(g.normal(size=(8, 6)))
    (z1, s1), (z2, s2) = _twice(lambda: scan_chunked(head, x, 4), lambda: _expand_params(head))
    assert opens["open"] == 2 * 2
    assert torch.equal(z1, z2) and s1 == s2


def test_elementwise_mul_with_a_compressed_operand_stays_composable(opens):
    ct.init(world_size=2, seed=2, device="cpu")
    gain = MPCTensor(SeedCompressedArithmetic.encrypt(np.linspace(0.5, 2.0, 6), KEY))
    x = ct.cryptensor(np.ones((3, 6)))
    np.testing.assert_allclose((x * gain).get_plain_text(), np.tile(np.linspace(0.5, 2.0, 6), (3, 1)),
                               atol=2 ** -14)
    assert opens["open"] == 0 and opens["expand"] >= 1


def test_tiny_compressed_gpt_open_route_is_bit_identical(opens):
    """A compressed GPT (2 blocks, 16 wide, chunked block linears and LM
    head, head_chunk_positions 4) under bench.py's kernel configuration:
    the forward's output shares and CommStats equal those of the same model
    with every compressed parameter swapped for its expansion."""
    from chip_smoke import BENCH_CONFIG, random_gpt2_state

    sd = random_gpt2_state(np.random.default_rng(0), GEOM["seq_len"], GEOM["num_blocks"],
                           d=GEOM["embed_dim"], vocab=GEOM["vocab_size"])
    ct.init(world_size=2, seed=5, device="cpu")
    with cfg.temp_override(dict(BENCH_CONFIG, **{"models.head_chunk_positions": 4})):
        model = GPT.build_compressed(**GEOM, head_vocab_chunks=4, chunk_block_linears=True,
                                     state_dict=sd)
        x = ct.cryptensor(TOKENS.astype(np.float64), precision=0)
        (z1, s1), (z2, s2) = _twice(lambda: model(x), lambda: _expand_params(model))
    # per block: the QKV's 3 chunks, the projection, the FFN's 4 + 4; the
    # embedding's 4 chunks and the head's 4, each over 2 chunks of positions
    assert opens["open"] == 2 * (3 + 1 + 4 + 4) + 2 * (4 + 4)
    assert torch.equal(z1, z2)
    assert s1 == s2


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_open_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the seed_expand kernel has no CPU version")
    shapes = [((13, 6), False), ((7, 5), True), ((65, 131), True), ((131, 65), True),
              ((3, 67, 129), True), ((768, 3072), True), ((6283, 768), False), ((1001,), False)]
    for shape, transposed in shapes:
        share0 = _i64(shape, 1).cuda()
        view = seed_expand.view_shape(share0, transposed)
        bs = [_i64((2,) + view, 2).cuda(), _i64((3,) + view, 3).cuda()[1:]]
        if len(view) >= 2:  # b read through the strides of a transposed buffer
            bs.append(_i64((2,) + view[:-2] + view[::-1][:2], 4).cuda().transpose(-1, -2))
        for b in bs:
            got = seed_expand.launch_open(share0, KEY, transposed, b)
            assert torch.equal(got, seed_expand.plain_open(share0, KEY, transposed, b)), shape


@pytest.mark.cuda
def test_ltz_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the max_step kernel has no CPU version")
    from curl_tpu_torch.kernels.keys import hold

    key, = hold((KEY,))
    for shape in ((2, 1, 64, 3072), (2, 100003), (2, 7)):
        d = _i64(shape, 4).cuda()
        want = max_step.plain_ltz(d, key, 9)
        assert torch.equal(max_step.launch_ltz(d, key, 9), want)
        strided = d.transpose(-1, -2).contiguous().transpose(-1, -2)
        assert torch.equal(max_step.launch_ltz(strided, key, 9), want)
