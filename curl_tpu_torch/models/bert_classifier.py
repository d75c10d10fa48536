"""BERT for sequence classification under encryption, HF-weight compatible
(counterpart of ``curl_tpu/models/bert_classifier.py``).

The whole encoder (word, position and token-type embeddings, the embedding
LayerNorm, post-LN blocks), the ``[CLS]`` pooler with tanh and the
classification head, loadable from a HuggingFace
``BertForSequenceClassification`` state dict (``load_hf_state_dict``).
``load_safetensors`` reads such a checkpoint's ``model.safetensors`` with
numpy alone. ``plain_classifier_forward`` is the float64 forward of the
same weights. The word table is padded to the next power of two, since the
private embedding takes its one-hot index mod the table's size.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from .. import nn
from .bert import Bert, _plain_lin, _plain_ln, plain_blocks


class BertClassifierConfig:
    def __init__(self, vocab_size=30522, hidden=128, heads=2, layers=2, intermediate=512,
                 max_pos=512, type_vocab=2, num_labels=2, seq_len=128):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.heads = heads
        self.layers = layers
        self.intermediate = intermediate
        self.max_pos = max_pos
        self.type_vocab = type_vocab
        self.num_labels = num_labels
        self.seq_len = seq_len


class BertForSequenceClassification(nn.Module):
    def __init__(self, cfg: BertClassifierConfig):
        super().__init__()
        self.cfg = cfg
        self.padded_vocab = 1 << math.ceil(math.log2(cfg.vocab_size))
        self.word_embeddings = nn.Embedding(self.padded_vocab, cfg.hidden)
        self.register_param("position_embeddings",
                            torch.zeros((1, cfg.seq_len, cfg.hidden), dtype=torch.float64))
        self.token_type_embeddings = nn.Embedding(max(cfg.type_vocab, 2), cfg.hidden)
        self.embed_ln = nn.LayerNorm(cfg.hidden)
        self.blocks = nn.Sequential(*[Bert.Block(cfg.hidden, cfg.heads, cfg.intermediate)
                                      for _ in range(cfg.layers)])
        self.pooler = nn.Linear(cfg.hidden, cfg.hidden)
        self.classifier = nn.Linear(cfg.hidden, cfg.num_labels)

    def embed(self, input_ids, token_type_ids=None):
        """Encrypted ids (precision 0, shape (b, t)) -> the embedding after
        its LayerNorm."""
        x = self.word_embeddings(input_ids)
        x = x + self._params["position_embeddings"][:, : input_ids.shape[1], :]
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.embed_ln(x)

    def head(self, x):
        """The last block's output -> logits: the [CLS] position, the pooler
        with tanh, the classifier."""
        return self.classifier(self.pooler(x[:, 0, :]).tanh())

    def forward(self, input_ids, token_type_ids=None):
        x = self.embed(input_ids, token_type_ids)
        for block in self.blocks:
            x = block(x)
        return self.head(x)

    def load_hf_state_dict(self, sd):
        """Map a HuggingFace BertForSequenceClassification state dict (a
        mapping of tensors or arrays) onto this plaintext model
        (bert_classifier.py:93-143): the word table zero-padded to
        ``padded_vocab`` rows, the position table cut to ``seq_len``, each
        block's query, key and value weights stacked into the QKV linear."""

        def g(key):
            t = sd[key]
            arr = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
            return torch.from_numpy(np.array(arr, dtype=np.float64))

        w = g("bert.embeddings.word_embeddings.weight")
        pad = self.padded_vocab - w.shape[0]
        if pad > 0:
            w = torch.cat([w, w.new_zeros((pad, w.shape[1]))])
        self.word_embeddings._params["weight"] = w
        pos = g("bert.embeddings.position_embeddings.weight")
        self._params["position_embeddings"] = pos[None, : self.cfg.seq_len].clone()
        self.token_type_embeddings._params["weight"] = g(
            "bert.embeddings.token_type_embeddings.weight")
        for name in ("weight", "bias"):
            self.embed_ln._params[name] = g(f"bert.embeddings.LayerNorm.{name}")
        for i, block in enumerate(self.blocks):
            p = f"bert.encoder.layer.{i}."
            for name in ("weight", "bias"):
                block.attn.search._params[name] = torch.cat(
                    [g(f"{p}attention.self.{m}.{name}") for m in ("query", "key", "value")], 0)
                block.attn.proj._params[name] = g(f"{p}attention.output.dense.{name}")
                block.ln1._params[name] = g(f"{p}attention.output.LayerNorm.{name}")
                block.ff._modules["0"]._params[name] = g(f"{p}intermediate.dense.{name}")
                block.ff._modules["2"]._params[name] = g(f"{p}output.dense.{name}")
                block.ln2._params[name] = g(f"{p}output.LayerNorm.{name}")

        for name in ("weight", "bias"):
            self.pooler._params[name] = g(f"bert.pooler.dense.{name}")
            self.classifier._params[name] = g(f"classifier.{name}")
        return self


def BertTinyForSequenceClassification(seq_len=128, num_labels=2):
    return BertForSequenceClassification(BertClassifierConfig(
        hidden=128, heads=2, layers=2, intermediate=512, num_labels=num_labels,
        seq_len=seq_len))


def BertBaseForSequenceClassification(seq_len=128, num_labels=2):
    return BertForSequenceClassification(BertClassifierConfig(
        hidden=768, heads=12, layers=12, intermediate=3072, num_labels=num_labels,
        seq_len=seq_len))


# safetensors dtypes -> numpy, little-endian
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4"}


def load_safetensors(path):
    """The tensors of a ``.safetensors`` file as numpy arrays, by name: an
    8-byte little-endian header length, a JSON header of each tensor's
    dtype, shape and byte range, then the raw little-endian data."""
    with open(path, "rb") as f:
        blob = f.read()
    n = int.from_bytes(blob[:8], "little")
    header = json.loads(blob[8:8 + n])
    data = memoryview(blob)[8 + n:]
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        arr = np.frombuffer(data[lo:hi], dtype=_ST_DTYPES[meta["dtype"]])
        out[name] = arr.reshape(meta["shape"]).astype(arr.dtype.newbyteorder("="))
    return out


def plain_classifier_forward(sd, input_ids, token_type_ids, cfg, device="cpu", skip=None,
                             eps=1e-5):
    """float64 logits of a ``BertForSequenceClassification``'s state dict
    (its own keys, numpy arrays or tensors) on plaintext ids, block ``skip``
    left out. ``eps`` is the LayerNorms' (the private model's 1e-5; HF's
    checkpoints say 1e-12)."""
    W = {k: torch.as_tensor(v, dtype=torch.float64, device=device) for k, v in sd.items()}
    ids = torch.as_tensor(input_ids, dtype=torch.int64, device=device)
    x = W["word_embeddings.weight"][ids] + W["position_embeddings"][:, : ids.shape[1]]
    if token_type_ids is not None:
        types = torch.as_tensor(token_type_ids, dtype=torch.int64, device=device)
        x = x + W["token_type_embeddings.weight"][types]
    x = plain_blocks(W, _plain_ln(W, "embed_ln", x, eps), cfg.heads, cfg.layers, skip=skip,
                     eps=eps)
    pooled = torch.tanh(_plain_lin(W, "pooler", x[:, 0, :]))
    return _plain_lin(W, "classifier", pooled)
