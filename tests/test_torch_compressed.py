"""Seed-compressed weights in the port (mpc/primitives/compressed.py,
kernels/seed_expand.py, nn/module.py's ChunkedLinear and scan_chunked,
models/gpt.py's build_compressed) against curl_tpu and against the port's
own materialized path.

One module-scoped fixture builds curl_tpu's tiny compressed GPT (16 wide, 2
heads, 2 blocks, vocabulary 50 in 4 chunks, seq 8, chunked block linears,
``head_chunk_positions: 4``), which reaches every chunked module. Its
leaves are decoded (share0 plus the tensor's threefry bits, then the
encoder) into a state dict under the materialized model's keys, and the
port builds its compressed GPT from that dict. curl_tpu's compressed
forward runs only compiled, and compiling the whole tiny forward takes
minutes on a CPU; so the test traces it once for its CommStats (counted at
trace time), runs its chunked embedding, LM head and block 0's two kinds of
ChunkedLinear compiled (seconds), and holds the port's whole forward to the
float64 forward of the same weights.
The streams differ (threefry there, Philox here): compare decoded values
and counts, never shares.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import curl_tpu  # noqa: E402
from curl_tpu import comm as jcomm  # noqa: E402
from curl_tpu import models as jmodels  # noqa: E402
from curl_tpu.mpc.primitives.compressed import bits_for_impl  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import random as prng  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.kernels import philox, seed_expand  # noqa: E402
from curl_tpu_torch.models import GPT, load_numpy_state_dict  # noqa: E402
from curl_tpu_torch.mpc.mpc import MPCTensor  # noqa: E402
from curl_tpu_torch.mpc.primitives import beaver  # noqa: E402
from curl_tpu_torch.mpc.primitives.compressed import SeedCompressedArithmetic  # noqa: E402
from curl_tpu_torch.nn.module import ChunkedLinear, scan_chunked, stack_compressed_chunks  # noqa: E402

GEOM = dict(embed_dim=16, num_heads=2, num_blocks=2, vocab_size=50, seq_len=8)
CHUNKS = 4
HEAD_CHUNK = {"models.head_chunk_positions": 4}
TOKENS = np.arange(8).reshape(1, 8) * 7 % 50
# inputs of block 0's ChunkedLinears: the QKV projection (3 chunks of output
# features) and the FFN down projection (4 chunks of input features)
CHUNKED_INPUTS = {"attn.search": np.random.default_rng(10).normal(size=(8, 16)),
                  "ff.2": np.random.default_rng(11).normal(size=(8, 64))}


# ---------------------------------------------------------------------------
# the seed expansion's plain version
# ---------------------------------------------------------------------------

def test_plain_compress_expand_reconstruct_the_encoding():
    e = torch.from_numpy(np.random.default_rng(0).integers(-(2 ** 62), 2 ** 62, size=(7, 9)))
    key = 0x1234_5678_9ABC_DEF0
    share0 = seed_expand.compress(e, key)
    both = seed_expand.expand(share0, key)
    assert both.shape == (2, 7, 9)
    assert torch.equal(both[0], share0)
    assert torch.equal(both[1], philox.stream(key, 0, 63, "cpu").reshape(7, 9))
    assert torch.equal(both.sum(0), e)
    assert torch.equal(seed_expand.expand(share0, key, parties=1), e.unsqueeze(0))


def _compressed_keys(model):
    keys = []
    for _, p in model.named_params():
        for t in p if isinstance(p, list) else [p]:
            assert isinstance(t._tensor, SeedCompressedArithmetic)
            keys.append(t._tensor.key)
    return keys


def test_keys_differ_across_tensors_and_chunks_and_from_the_session_seeds():
    ct.init(world_size=2, seed=3, device="cpu")
    model = GPT.build_compressed(**GEOM, head_vocab_chunks=CHUNKS, chunk_block_linears=True)
    keys = _compressed_keys(model)
    # 2 blocks x (4 LayerNorm + 3 biases of the chunked linears + 3 + 4 + 4
    # chunks + the projection's 2), the head's 4 chunks and bias, the
    # embedding's 4 chunks, pos_embed and the final LayerNorm's 2
    assert len(keys) == 2 * 20 + 5 + 4 + 3 == len(set(keys))
    streams = {k for ks in prng.current_keys().values() for k in ks}
    assert not streams & set(keys)
    # init restarts the construction counter: the same session, the same keys
    ct.init(world_size=2, seed=3, device="cpu")
    again = GPT.build_compressed(**GEOM, head_vocab_chunks=CHUNKS, chunk_block_linears=True)
    assert _compressed_keys(again) == keys


def test_one_party_decodes_and_three_parties_raise():
    v = np.linspace(-4, 4, 12).reshape(3, 4)
    ct.init(world_size=1, seed=0, device="cpu")
    t = SeedCompressedArithmetic.encrypt(v, 77)
    assert t.share.shape == (1, 3, 4)
    np.testing.assert_allclose(t.get_plain_text(), v, atol=2 ** -16)
    ct.init(world_size=3, seed=6, device="cpu")
    w = MPCTensor(SeedCompressedArithmetic.encrypt(np.ones((2, 2)), 5))
    x = ct.cryptensor(np.ones((2, 2)))
    with pytest.raises(RuntimeError, match="2PC-only"):
        x * w


def test_resident_share_bytes_at_most_0_6_of_materialized():
    sd = _random_state(GEOM)
    ct.init(world_size=2, seed=0, device="cpu")
    dense = load_numpy_state_dict(GPT(**GEOM), sd).encrypt()
    packed = GPT.build_compressed(**GEOM, head_vocab_chunks=CHUNKS, state_dict=sd)
    assert packed.resident_share_bytes() < 0.6 * dense.resident_share_bytes()


@pytest.mark.parametrize("axis", [0, 1])
def test_stack_compressed_chunks_pads_with_zeros(axis):
    ct.init(world_size=2, seed=0, device="cpu")
    w = torch.arange(1.0, 31.0, dtype=torch.float64).reshape(10, 3)
    w = w if axis == 0 else w.t().contiguous()
    chunks, cl, padded = stack_compressed_chunks(w, 4, axis, 0xABC)
    assert (cl, padded) == (3, 12)
    got = np.concatenate([c.get_plain_text() for c in chunks], axis=axis)
    want = np.concatenate([w.numpy(), np.zeros((2, 3) if axis == 0 else (3, 2))], axis=axis)
    np.testing.assert_array_equal(got, want)
    assert len({c._tensor.key for c in chunks}) == 4


# ---------------------------------------------------------------------------
# chunked modules against their unchunked port counterparts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
def test_chunked_linear_decodes_like_linear(axis):
    from curl_tpu_torch import nn

    rng = np.random.default_rng(axis)
    w = rng.uniform(-0.5, 0.5, size=(12, 10))  # 4 chunks of 3 rows, or of 3 columns + 2 pad
    b = rng.uniform(-0.5, 0.5, size=12)
    x = rng.normal(size=(2, 5, 10))
    ct.init(world_size=2, seed=1, device="cpu")
    lin = nn.Linear(10, 12)
    lin._params.update(weight=torch.from_numpy(w), bias=torch.from_numpy(b))
    xe = ct.cryptensor(x)
    want = lin.encrypt()(xe).get_plain_text()
    chunked = ChunkedLinear(torch.from_numpy(w), torch.from_numpy(b), 4, axis)
    got = chunked.encrypt(seed_compress=True)(xe).get_plain_text()
    # each product is truncated once per chunk: a unit of 2^-16 per chunk
    np.testing.assert_allclose(got, want, atol=CHUNKS * 2 ** -15, rtol=0)
    np.testing.assert_allclose(got, x @ w.T + b, atol=CHUNKS * 2 ** -15, rtol=0)


def test_evaluate_embed_chunked_decodes_like_evaluate_embed():
    table = np.random.default_rng(4).normal(size=(50, 6))
    ct.init(world_size=2, seed=2, device="cpu")
    x = ct.cryptensor(TOKENS.astype(np.float64), precision=0)
    dense = ct.cryptensor(table)
    chunks, _, _ = stack_compressed_chunks(torch.from_numpy(table), CHUNKS, 0, 99)
    ct.reset_communication_stats()
    got = beaver.evaluate_embed_chunked(x._tensor, [c._tensor for c in chunks], 50, 6)
    chunked_rounds = ct.get_communication_stats()["rounds"]
    ct.reset_communication_stats()
    want = x._tensor.evaluate_embed(dense._tensor)
    assert (chunked_rounds, ct.get_communication_stats()["rounds"]) == (1 + CHUNKS, 2)
    # a one-hot lookup is exact: both return the table's encodings
    got = got.share.sum(0).numpy() / 2 ** 16
    np.testing.assert_array_equal(got, want.get_plain_text())
    np.testing.assert_array_equal(got, np.trunc(table[TOKENS] * 2 ** 16) / 2 ** 16)


def test_scan_chunked_with_head_chunk_positions_equals_the_direct_call(port_run):
    model = port_run["model"]
    ct.init(world_size=2, seed=9, device="cpu")
    x = ct.cryptensor(TOKENS.reshape(8).astype(np.float64), precision=0)
    ct.reset_communication_stats()
    direct = model.tok_embed(x).get_plain_text()
    once = ct.get_communication_stats()
    ct.reset_communication_stats()
    chunked = scan_chunked(model.tok_embed, x, 4).get_plain_text()
    twice = ct.get_communication_stats()
    np.testing.assert_array_equal(chunked, direct)
    assert twice["rounds"] == 2 * once["rounds"]
    # not a multiple of the chunk, or not above it: the direct call
    for n, chunk in ((8, 3), (8, 8)):
        ct.reset_communication_stats()
        scan_chunked(model.tok_embed, x, chunk)
        assert ct.get_communication_stats() == once


def test_head_chunk_positions_on_materialized_weights_raises():
    """Materialized weights under head_chunk_positions raised until the
    Beaver-masked reuse was ported (PR 9): the chunk loop now masks the
    embedding table and the head's weight once (MaskedArithmetic) and
    decodes as the unchunked forward does."""
    from curl_tpu_torch.mpc.primitives.beaver import MaskedArithmetic

    ct.init(world_size=2, seed=0, device="cpu")
    model = load_numpy_state_dict(GPT(**GEOM), _random_state(GEOM)).encrypt()
    apply_fn, params = model.functional()
    x = ct.cryptensor(TOKENS.astype(np.float64), precision=0)
    direct = apply_fn(params, x).get_plain_text()
    with cfg.temp_override(HEAD_CHUNK):
        chunked = apply_fn(params, x).get_plain_text()
    assert type(model.tok_embed.weight._tensor) is MaskedArithmetic
    assert type(model.fc.weight._tensor) is MaskedArithmetic
    np.testing.assert_allclose(chunked, direct, atol=0.05)


# ---------------------------------------------------------------------------
# the slice as a whole: the tiny compressed GPT against curl_tpu
# ---------------------------------------------------------------------------

def _random_state(geom):
    from chip_smoke import random_gpt2_state

    return random_gpt2_state(np.random.default_rng(0), geom["seq_len"], geom["num_blocks"],
                             d=geom["embed_dim"], vocab=geom["vocab_size"])


def _decode_jax(p):
    """A curl_tpu compressed MPCTensor leaf, stacked or not, decoded:
    share0 + bits_for_impl(key) per stacked key, then the encoder."""
    t = p._tensor
    share0 = np.asarray(t.share0)
    key = np.asarray(t.key)
    lead = key.shape[:-1]
    enc = np.empty(share0.shape, dtype=np.int64)
    for idx in np.ndindex(*lead):
        bits = np.asarray(bits_for_impl(key[idx], share0.shape[len(lead):], t._impl))
        enc[idx] = (share0[idx] + bits).view(np.int64)
    return enc / t.encoder.scale


def _unchunk(chunks, axis, shape):
    """Concatenate decoded chunks along ``axis`` and drop the padding."""
    full = np.concatenate(list(chunks), axis=axis)
    return full[tuple(slice(0, n) for n in shape)]


def _jax_state(m):
    """curl_tpu's compressed GPT decoded into the materialized model's keys."""
    from curl_tpu.nn.module import ChunkedLinear as JChunked

    d, V = GEOM["embed_dim"], GEOM["vocab_size"]
    sd = {"pos_embed": _decode_jax(m._parameters["pos_embed"]),
          "tok_embed.weight": _unchunk(_decode_jax(m.tok_embed._parameters["tchunks"]), 0, (V, d)),
          "fc.weight": _unchunk(_decode_jax(m.fc._parameters["wchunks"]), 0, (V, d)),
          "fc.bias": _decode_jax(m.fc._parameters["bias"]),
          "ln.weight": _decode_jax(m.ln._parameters["weight"]),
          "ln.bias": _decode_jax(m.ln._parameters["bias"])}
    stacked = m.blocks._parameters["stacked"]
    for path, mod in m.blocks.template.named_modules():
        node = stacked
        for part in path.split(".") if path else []:
            node = node[part]
        for name, leaf in node["__params__"].items():
            values = _decode_jax(leaf)
            for b in range(GEOM["num_blocks"]):
                if isinstance(mod, JChunked) and name == "wchunks":
                    shape = (mod.out_features, mod.in_features)
                    sd[f"blocks.{b}.{path}.weight"] = _unchunk(values[b], mod.axis, shape)
                else:
                    sd[f"blocks.{b}.{path}.{name}"] = values[b]
    return sd


def _port_state(model):
    """The port's compressed GPT decoded into the same keys."""
    out = {}
    for key, p in model.named_params():
        if isinstance(p, list):
            mod = model.get_submodule(key.rsplit(".", 1)[0])
            decoded = [c.get_plain_text() for c in p]
            if isinstance(mod, ChunkedLinear):
                shape, axis = (mod.out_features, mod.in_features), mod.axis
            else:
                shape, axis = (mod.vocab, decoded[0].shape[1]), 0
            out[key.rsplit(".", 1)[0] + ".weight"] = _unchunk(decoded, axis, shape)
        else:
            out[key] = p.get_plain_text()
    return out


@pytest.fixture(scope="module")
def jax_run():
    """curl_tpu's tiny compressed GPT: decoded weights, the CommStats of its
    traced forward, and its chunked embedding, LM head and block 0's
    ChunkedLinears run compiled."""
    with curl_tpu.cfg.temp_override(HEAD_CHUNK):
        curl_tpu.init(world_size=2, seed=21)
        m = jmodels.GPT.build_compressed(**GEOM, head_vocab_chunks=CHUNKS,
                                         chunk_block_linears=True)
        # decoded before any trace binds traced values into the model
        sd = _jax_state(m)
        apply_fn, params = m.functional()
        xe = curl_tpu.cryptensor(TOKENS.astype(np.float64), precision=0)
        jcomm.reset_communication_stats()
        forward = curl_tpu.compile_parties(apply_fn, world_size=2)
        jax.make_jaxpr(forward)(jax.random.PRNGKey(5), params, xe.mpc)
        stats = jcomm.get_communication_stats()

        def pieces(p, tokens, rows, xa, xb):
            m.bind_params(p)
            # block 0's parameters, as the block scan slices them
            block = m.blocks.template.bind_params(jax.tree_util.tree_map(
                lambda leaf: leaf[0], m.blocks._parameters["stacked"]))
            return (m.tok_embed(tokens), m.fc(rows), block.attn.search(xa),
                    block.ff._modules["2"](xb))

        rows = np.random.default_rng(8).normal(size=(8, GEOM["embed_dim"]))
        flat = curl_tpu.cryptensor(TOKENS.reshape(8).astype(np.float64), precision=0)
        run = curl_tpu.compile_parties(pieces, world_size=2)
        outs = run(jax.random.PRNGKey(6), params, flat.mpc,
                   *[curl_tpu.cryptensor(x).mpc for x in (rows, *CHUNKED_INPUTS.values())])
        decoded = [np.asarray(curl_tpu.CrypTensor(o).get_plain_text()) for o in outs]
    return dict(sd=sd, stats=stats, rows=rows, embedding=decoded[0], head=decoded[1],
                chunked=dict(zip(CHUNKED_INPUTS, decoded[2:])))


def _stats(before, after):
    out = {"rounds": after["rounds"] - before["rounds"], "bytes": after["bytes"] - before["bytes"],
           "calls": {}}
    for name, n in after["calls"].items():
        if n - before["calls"].get(name, 0):
            out["calls"][name] = n - before["calls"].get(name, 0)
    return out


def _combine(*terms):
    """sum of k * stats over (k, stats) terms."""
    out = {"rounds": 0, "bytes": 0, "calls": {}}
    for k, st in terms:
        out["rounds"] += k * st["rounds"]
        out["bytes"] += k * st["bytes"]
        for name, n in st["calls"].items():
            out["calls"][name] = out["calls"].get(name, 0) + k * n
    out["calls"] = {name: n for name, n in out["calls"].items() if n}
    return out


def _watch(model):
    """Hooks recording the CommStats of every call of the forward's units:
    the embedding, each block, each ChunkedLinear, the LM head, and the head
    stage (final LayerNorm to softmax). Returns (records, remove)."""
    records, handles = {}, []

    def bracket(name, first, last):
        def pre(mod, inp):
            records.setdefault(name, []).append(ct.get_communication_stats())

        def post(mod, inp, out):
            records[name][-1] = _stats(records[name][-1], ct.get_communication_stats())

        handles.append(first.register_forward_pre_hook(pre))
        handles.append(last.register_forward_hook(post))

    bracket("embedding", model.tok_embed, model.tok_embed)
    bracket("head", model.ln, model.softmax)
    bracket("lm_head", model.fc, model.fc)
    for i, blk in enumerate(model.blocks):
        bracket(f"block{i}", blk, blk)
        for name, mod in blk.named_modules():
            if isinstance(mod, ChunkedLinear):
                bracket(f"block{i}.{name}", mod, mod)
    return records, lambda: [h.remove() for h in handles]


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's compressed GPT built from curl_tpu's decoded weights: one
    forward with every unit's CommStats, its final-LayerNorm hidden state
    and output; the same forward with block 0 left out; the plaintext."""
    from test_torch_gpt import plain_forward

    sd = jax_run["sd"]
    ct.init(world_size=2, seed=5, device="cpu")
    with cfg.temp_override(HEAD_CHUNK):
        model = GPT.build_compressed(**GEOM, head_vocab_chunks=CHUNKS, chunk_block_linears=True,
                                     state_dict=sd)
        x = ct.cryptensor(TOKENS.astype(np.float64), precision=0)
        records, remove = _watch(model)
        hidden, logits = [], []
        hooks = [model.ln.register_forward_hook(lambda m, i, o: hidden.append(o.get_plain_text())),
                 model.fc.register_forward_hook(lambda m, i, o: logits.append(o.get_plain_text()))]
        ct.reset_communication_stats()
        try:
            probs = model(x).get_plain_text()
        finally:
            remove()
            for hook in hooks:
                hook.remove()
        stats = ct.get_communication_stats()
        h = model.embed(x)
        for blk in list(model.blocks)[1:]:
            h = blk(h)
        fault_hidden = model.ln(h).get_plain_text()
        fault_logits = model.fc(model.ln(h)).get_plain_text()
        embedding = model.tok_embed(ct.cryptensor(TOKENS.reshape(8).astype(np.float64),
                                                  precision=0)).get_plain_text()
        head = model.fc(ct.cryptensor(jax_run["rows"])).get_plain_text()
        block = list(model.blocks)[0]
        chunked = {path: block.get_submodule(path)(ct.cryptensor(x)).get_plain_text()
                   for path, x in CHUNKED_INPUTS.items()}
    hiddens, ref_logits, ref_probs = plain_forward(sd, TOKENS, GEOM["num_heads"],
                                                   GEOM["num_blocks"])
    return dict(model=model, records=records, stats=stats, probs=probs, embedding=embedding,
                head=head, chunked=chunked, ref_probs=ref_probs,
                sound=dict(hidden=np.concatenate(hidden).reshape(1, 8, -1),
                           logits=np.concatenate(logits).reshape(1, 8, -1)),
                fault=dict(hidden=fault_hidden, logits=fault_logits),
                plaintext=dict(hidden=hiddens[-1], logits=ref_logits))


def test_port_weights_decode_to_curl_tpus(jax_run, port_run):
    """The port compresses the encodings curl_tpu's weights decode to: its
    own share0 + Philox stream decodes to them exactly."""
    got = _port_state(port_run["model"])
    assert sorted(got) == sorted(jax_run["sd"])
    for key, want in jax_run["sd"].items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)


def test_chunked_embedding_equals_curl_tpus(jax_run, port_run):
    # a one-hot lookup is exact in both packages
    np.testing.assert_array_equal(port_run["embedding"], jax_run["embedding"])


def test_chunked_lm_head_matches_curl_tpus(jax_run, port_run):
    # each decodes within a unit of 2^-16 of the exact product (EGK)
    np.testing.assert_allclose(port_run["head"], jax_run["head"], atol=2 ** -15, rtol=0)
    want = jax_run["rows"] @ jax_run["sd"]["fc.weight"].T + jax_run["sd"]["fc.bias"]
    np.testing.assert_allclose(port_run["head"], want, atol=2 ** -12, rtol=0)


@pytest.mark.parametrize("path", list(CHUNKED_INPUTS))
def test_chunked_linear_matches_curl_tpus(jax_run, port_run, path):
    """Block 0's ChunkedLinear by output features (attn.search) and by input
    features (ff.2) on the same decoded weights and inputs as curl_tpu's."""
    mod = list(port_run["model"].blocks)[0].get_submodule(path)
    assert isinstance(mod, ChunkedLinear) and mod.axis == (0 if path == "attn.search" else 1)
    got, theirs = port_run["chunked"][path], jax_run["chunked"][path]
    # each side truncates once per chunk: a unit of 2^-16 per chunk
    np.testing.assert_allclose(got, theirs, atol=CHUNKS * 2 ** -15, rtol=0)
    sd = jax_run["sd"]
    want = CHUNKED_INPUTS[path] @ sd[f"blocks.0.{path}.weight"].T + sd[f"blocks.0.{path}.bias"]
    np.testing.assert_allclose(got, want, atol=CHUNKS * 2 ** -15, rtol=0)


@pytest.mark.parametrize("run", ["sound", "fault"])
@pytest.mark.parametrize("stage", ["hidden", "logits"])
def test_tiny_compressed_gpt_against_plaintext(port_run, run, stage):
    """The bounds of the tiny materialized GPT test (tests/test_torch_gpt.py):
    the sound forward within, block 0 left out beyond."""
    from chip_smoke import hidden_stats
    from test_torch_gpt import TINY_BOUNDS

    stat, bound = TINY_BOUNDS[stage]
    err = hidden_stats(port_run[run][stage], port_run["plaintext"][stage])[stat]
    assert (err <= bound) if run == "sound" else (err > bound), err


def test_tiny_compressed_gpt_probabilities_match_plaintext(port_run):
    # the atol of the tiny materialized GPT test against the plaintext
    assert np.abs(port_run["probs"] - port_run["ref_probs"]).max() < 0.1


def _scaled(st, num, den):
    """num/den of a chunked product's stats (den equal chunks)."""
    assert st["rounds"] % den == 0 and st["bytes"] % den == 0
    return {"rounds": st["rounds"] * num // den, "bytes": st["bytes"] * num // den,
            "calls": {name: c * num // den for name, c in st["calls"].items()}}


def _embedding_chunk_stats(rows):
    """One vocab chunk's Beaver product of the chunked embedding, at
    ``rows`` positions."""
    vc = -(-GEOM["vocab_size"] // CHUNKS)
    ct.init(world_size=2, seed=0, device="cpu")
    onehot = ct.cryptensor(np.zeros((rows, vc)), precision=0)._tensor
    table = ct.cryptensor(np.zeros((vc, GEOM["embed_dim"])))._tensor
    ct.reset_communication_stats()
    beaver.matmul(onehot, table)
    return ct.get_communication_stats()


@pytest.mark.parametrize("key", ["rounds", "bytes", "calls"])
def test_tiny_compressed_gpt_comm_stats_equal_curl_tpus_trip_weighted(jax_run, port_run, key):
    """curl_tpu counts CommStats while tracing, so each lax.scan body counts
    once: one position chunk of the embedding and of the head stage, one
    block, one vocab chunk of the embedding and of the LM head, one chunk of
    each ChunkedLinear. The port counts every iteration; from its count of
    each unit's first call, less the iterations curl_tpu does not count,
    the counts must be curl_tpu's."""
    rec, model = port_run["records"], port_run["model"]
    blocks = list(model.blocks)
    # the units cover the port's forward (the adds between them are free)
    covered = _combine(*[(1, st) for name in ("embedding", "head") for st in rec[name]],
                       *[(1, rec[f"block{i}"][0]) for i in range(len(blocks))])
    assert covered[key] == port_run["stats"][key]
    assert [len(rec[name]) for name in ("embedding", "head", "lm_head")] == [2, 2, 2]

    terms = [(1, rec["embedding"][0]), (-(CHUNKS - 1), _embedding_chunk_stats(4)),
             (1, rec["block0"][0]), (1, rec["head"][0]),
             (-1, _scaled(rec["lm_head"][0], CHUNKS - 1, CHUNKS))]
    for name, mod in blocks[0].named_modules():
        if isinstance(mod, ChunkedLinear):
            terms.append((-1, _scaled(rec[f"block0.{name}"][0], mod.n_chunks - 1, mod.n_chunks)))
    assert _combine(*terms)[key] == jax_run["stats"][key]


# ---------------------------------------------------------------------------
# the same tiny model under bench.py's kernel configuration (port only)
# ---------------------------------------------------------------------------

def test_tiny_compressed_gpt_bench_config_engages_every_plain_version():
    """At 64 positions and 32 wide every fused pass's element gate opens; on
    the CPU each kernel's plain version stands where a CUDA tensor would
    launch it."""
    from chip_smoke import BENCH_CONFIG, hidden_stats, random_gpt2_state
    from test_torch_fused import _spy_plain
    from test_torch_gpt import TINY_BOUNDS, plain_forward

    geom = dict(embed_dim=32, num_heads=2, num_blocks=1, vocab_size=50, seq_len=64)
    sd = random_gpt2_state(np.random.default_rng(2), 64, 1, d=32, vocab=50)
    tokens = np.random.default_rng(3).integers(0, 50, size=(1, 64))
    calls = {}
    undo = _spy_plain(calls)
    expand = seed_expand.plain_expand

    def counted(*args, **kwargs):
        calls["plain_expand"] = calls.get("plain_expand", 0) + 1
        return expand(*args, **kwargs)

    seed_expand.plain_expand = counted
    try:
        ct.init(world_size=2, seed=4, device="cpu")
        with cfg.temp_override(BENCH_CONFIG):
            model = GPT.build_compressed(**geom, head_vocab_chunks=CHUNKS,
                                         chunk_block_linears=True, state_dict=sd)
            hidden = []
            model.ln.register_forward_hook(lambda m, i, o: hidden.append(o.get_plain_text()))
            model(ct.cryptensor(tokens.astype(np.float64), precision=0))
    finally:
        undo()
        seed_expand.plain_expand = expand
    for key in ("mul+egk", "square+crypten", "trunc+egk", "plain_ltz", "plain_max_step",
                "plain_expand"):
        assert calls.get(key, 0) > 0, calls
    stat, bound = TINY_BOUNDS["hidden"]
    want = plain_forward(sd, tokens, 2, 1)[0][-1]
    assert hidden_stats(hidden[0].reshape(want.shape), want)[stat] <= bound
