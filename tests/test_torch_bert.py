"""The port's BERT models against curl_tpu and HuggingFace.

* ``load_safetensors`` reads the repo's bert-tiny-qnli checkpoint bit for
  bit as ``safetensors.numpy.load_file`` does;
* the port's float64 classifier (``plain_classifier_forward``) against
  ``transformers.BertForSequenceClassification.from_pretrained`` of that
  directory on 2 rows: exact at HF's own LayerNorm eps, and within 0.02 of
  the checkpoint's eps of 1e-12 (the private model's LayerNorms take
  curl_tpu's default, 1e-5);
* a private tiny ``Bert`` (2 blocks, width 16, vocab 64) and a private tiny
  classifier at seq 16, their weights carried across from curl_tpu's state
  dicts by ``load_numpy_state_dict``: the last block's output within a
  bound of the float64 forward, a block left out above it; rounds and
  bytes equal curl_tpu's forward traced with ``jax.make_jaxpr``, at one
  block (curl_tpu scans two or more blocks and counts the scan body once,
  ROADMAP Queue C);
* ``GPTNeoLarge``'s geometry and parameter names equal curl_tpu's.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import curl_tpu  # noqa: E402
from curl_tpu import comm as jcomm  # noqa: E402
from curl_tpu import models as jmodels  # noqa: E402
from curl_tpu.mpc.mpc import MPCTensor as JMPCTensor  # noqa: E402
from curl_tpu.parallel import compile_parties as jcompile  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import models as tmodels  # noqa: E402
from curl_tpu_torch.models import load_numpy_state_dict  # noqa: E402
from curl_tpu_torch.models.bert import plain_bert_forward  # noqa: E402
from curl_tpu_torch.models.bert_classifier import plain_classifier_forward  # noqa: E402

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks",
                    "checkpoints", "bert-tiny-qnli")
TINY = dict(embed_dim=16, num_heads=2, num_blocks=2, vocab_size=64, seq_len=16)
CLS = dict(vocab_size=64, hidden=16, heads=2, layers=2, intermediate=64, num_labels=2,
           seq_len=16)
# the last block's output against float64 (chip_smoke.hidden_stats'
# scale-free relative L2), both tiny models: the bound sits between the
# sound private forward's reading and the one with block 1 left out
TINY_SCALE_FREE_L2 = 0.15


def _scale_free_l2(got, ref):
    g = np.asarray(got).reshape(-1, np.shape(got)[-1])
    r = np.asarray(ref).reshape(-1, np.shape(ref)[-1])
    scale = (g * r).sum(-1, keepdims=True) / (r * r).sum(-1, keepdims=True)
    return float(np.linalg.norm(g - scale * r) / np.linalg.norm(scale * r))


def _zero_shares(tree):
    return jax.tree_util.tree_map(
        lambda p: JMPCTensor.from_shares(jnp.zeros((2,) + tuple(np.shape(p)), jnp.uint64)), tree)


def _jax_counts(module, *inputs, precision=0):
    """curl_tpu's rounds and bytes of ``module``'s forward, counted at trace."""
    apply_fn, params = module.functional()
    curl_tpu.init(world_size=2, seed=1234)
    enc = [curl_tpu.cryptensor(v, precision=precision).mpc for v in inputs]
    jcomm.reset_communication_stats()
    jax.make_jaxpr(jcompile(apply_fn, 2))(jax.random.PRNGKey(5), _zero_shares(params), *enc)
    s = jcomm.get_communication_stats()
    module.bind_params(params)
    return s["rounds"], s["bytes"]


def _tokens(rng, b, t, vocab):
    return rng.integers(0, vocab, size=(b, t))


# -- the checkpoint -------------------------------------------------------------

def test_load_safetensors_is_bit_exact():
    st = pytest.importorskip("safetensors.numpy")
    path = os.path.join(CKPT, "model.safetensors")
    want = st.load_file(path)
    got = tmodels.load_safetensors(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert np.array_equal(got[k].view(np.uint8), v.view(np.uint8)), k


def _qnli_rows(rng, rows, seq):
    """[CLS] a [SEP] b [SEP] then [PAD]: word ids in [5, 9322), type ids 0
    then 1."""
    ids = np.zeros((rows, seq), dtype=np.int64)
    types = np.zeros((rows, seq), dtype=np.int64)
    for r in range(rows):
        a, b = rng.integers(3, 12, size=2)
        ids[r, 0] = 2
        ids[r, 1:1 + a] = rng.integers(5, 9322, size=a)
        ids[r, 1 + a] = 3
        ids[r, 2 + a:2 + a + b] = rng.integers(5, 9322, size=b)
        ids[r, 2 + a + b] = 3
        types[r, 2 + a:3 + a + b] = 1
    return ids, types


def test_plain_classifier_matches_transformers():
    # the PyTorch classes only: transformers' TensorFlow and Flax imports
    # cost seconds
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    hf = transformers.BertForSequenceClassification.from_pretrained(CKPT).double().eval()
    model = tmodels.BertTinyForSequenceClassification(seq_len=64)
    model.load_hf_state_dict(tmodels.load_safetensors(os.path.join(CKPT, "model.safetensors")))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    ids, types = _qnli_rows(np.random.default_rng(0), 2, 64)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), token_type_ids=torch.from_numpy(types)).logits
    got = plain_classifier_forward(sd, ids, types, model.cfg)
    # the checkpoint's eps 1e-12 against the private model's 1e-5
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0.02)
    got = plain_classifier_forward(sd, ids, types, model.cfg, eps=hf.config.layer_norm_eps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-9)


# -- the private tiny models ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_bert():
    curl_tpu.init(world_size=2, seed=0)
    jm = jmodels.Bert(**TINY, full=True)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    x = _tokens(np.random.default_rng(1), 1, TINY["seq_len"], TINY["vocab_size"])
    one = jmodels.Bert(**dict(TINY, num_blocks=1), full=True)
    return dict(sd=sd, x=x, want=_jax_counts(one, x.astype(np.float64)))


def _port_bert(sd):
    ct.init(world_size=2, seed=0, device="cpu")
    model = load_numpy_state_dict(tmodels.Bert(**TINY, full=True), sd)
    return model.encrypt(src=0)


def test_tiny_bert_counts_equal_curl_tpus(tiny_bert):
    ct.init(world_size=2, seed=0, device="cpu")
    model = tmodels.Bert(**dict(TINY, num_blocks=1), full=True).encrypt(src=0)
    xe = ct.cryptensor(tiny_bert["x"].astype(np.float64), precision=0)
    ct.reset_communication_stats()
    out = model(xe)
    s = ct.get_communication_stats()
    assert (s["rounds"], s["bytes"]) == tiny_bert["want"]
    assert out.shape == (1, TINY["seq_len"], TINY["vocab_size"])


def _private_hidden(model, xe, skip=None):
    h = model.ln(model.embed(xe))
    for i, block in enumerate(model.blocks):
        if i != skip:
            h = block(h)
    return h.get_plain_text()


def test_tiny_bert_hidden_state_against_float64(tiny_bert):
    model = _port_bert(tiny_bert["sd"])
    xe = ct.cryptensor(tiny_bert["x"].astype(np.float64), precision=0)
    ref, probs = plain_bert_forward(tiny_bert["sd"], tiny_bert["x"], TINY["num_heads"],
                                    TINY["num_blocks"], "cpu")
    sound = _scale_free_l2(_private_hidden(model, xe), ref.numpy())
    fault = _scale_free_l2(_private_hidden(model, xe, skip=1), ref.numpy())
    assert sound <= TINY_SCALE_FREE_L2 < fault, (sound, fault)
    assert probs.shape == (1, TINY["seq_len"], TINY["vocab_size"])


@pytest.fixture(scope="module")
def tiny_classifier():
    curl_tpu.init(world_size=2, seed=0)
    jm = jmodels.BertForSequenceClassification(jmodels.bert_classifier.BertClassifierConfig(**CLS))
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    rng = np.random.default_rng(3)
    ids = _tokens(rng, 2, CLS["seq_len"], CLS["vocab_size"])
    types = (np.arange(CLS["seq_len"]) >= CLS["seq_len"] // 2).astype(np.int64)[None].repeat(2, 0)
    one = jmodels.BertForSequenceClassification(
        jmodels.bert_classifier.BertClassifierConfig(**dict(CLS, layers=1)))
    want = _jax_counts(one, ids.astype(np.float64), types.astype(np.float64))
    return dict(sd=sd, ids=ids, types=types, want=want)


def test_tiny_classifier_counts_equal_curl_tpus(tiny_classifier):
    t = tiny_classifier
    ct.init(world_size=2, seed=0, device="cpu")
    cfg = tmodels.BertClassifierConfig(**dict(CLS, layers=1))
    model = tmodels.BertForSequenceClassification(cfg).encrypt(src=0)
    ids = ct.cryptensor(t["ids"].astype(np.float64), precision=0)
    types = ct.cryptensor(t["types"].astype(np.float64), precision=0)
    ct.reset_communication_stats()
    logits = model(ids, types)
    s = ct.get_communication_stats()
    assert (s["rounds"], s["bytes"]) == t["want"]
    assert logits.shape == (2, CLS["num_labels"])


def test_tiny_classifier_against_float64(tiny_classifier):
    t = tiny_classifier
    ct.init(world_size=2, seed=0, device="cpu")
    cfg = tmodels.BertClassifierConfig(**CLS)
    model = load_numpy_state_dict(tmodels.BertForSequenceClassification(cfg), t["sd"])
    model.encrypt(src=0)
    ids = ct.cryptensor(t["ids"].astype(np.float64), precision=0)
    types = ct.cryptensor(t["types"].astype(np.float64), precision=0)
    x = model.embed(ids, types)
    hidden = []
    for skip in (None, 1):
        h = x
        for i, block in enumerate(model.blocks):
            h = h if i == skip else block(h)
        hidden.append(h)
    logits = model.head(hidden[0]).get_plain_text()
    W = {k: torch.as_tensor(v) for k, v in t["sd"].items()}
    from curl_tpu_torch.models.bert import _plain_ln, plain_blocks

    ref_x = (W["word_embeddings.weight"][t["ids"]] + W["position_embeddings"]
             + W["token_type_embeddings.weight"][t["types"]])
    ref = plain_blocks(W, _plain_ln(W, "embed_ln", ref_x, 1e-5), CLS["heads"], CLS["layers"])
    sound, fault = (_scale_free_l2(h.get_plain_text(), ref.numpy()) for h in hidden)
    assert sound <= TINY_SCALE_FREE_L2 < fault, (sound, fault)
    # the logits within 0.25 of float64: the pooler's haar tanh errs by up
    # to 0.13 an element (tests/test_torch_functions.py reads 0.129)
    want = plain_classifier_forward(t["sd"], t["ids"], t["types"], cfg).numpy()
    assert np.abs(logits - want).max() <= 0.25


def test_gpt_neo_large_geometry_and_names():
    assert tmodels.GPTNeoLarge.GEOM == jmodels.GPTNeoLarge.GEOM
    curl_tpu.init(world_size=2, seed=0)
    ct.init(world_size=2, seed=0, device="cpu")
    geom = dict(jmodels.GPTNeoLarge.GEOM, embed_dim=40, num_heads=20, num_blocks=2,
                vocab_size=50)
    want = jmodels.GPT(**geom, seq_len=4).state_dict()
    got = tmodels.GPT(**geom, seq_len=4).state_dict()
    assert list(got) == list(want) or sorted(got) == sorted(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                           for k, v in want.items()}
