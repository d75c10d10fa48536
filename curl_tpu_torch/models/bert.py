"""BERT family for private inference (counterpart of ``curl_tpu/models/bert.py``).

Post-LN transformer blocks (the LayerNorm after each residual add, where
GPT's come before), a LayerNorm on the embedding before the blocks and none
after them, and with ``full`` the private embedding lookup, the LM head and
a softmax over the vocabulary. The blocks run as a plain loop where the JAX
package scans them. Like the JAX package's, the forward takes no chunks of
positions (``models.head_chunk_positions`` is not read). Parameter names
are the JAX package's, so that ``load_numpy_state_dict`` carries its state
dicts across. ``plain_bert_forward`` is the float64 forward of the same
weights, the reference the private one is held against.
"""

from __future__ import annotations

import math

import torch

from .. import nn


class Bert(nn.Module):
    class Block(nn.Module):
        def __init__(self, embed_dim, num_heads, intermediate=None):
            super().__init__()
            intermediate = intermediate or 4 * embed_dim
            self.ln1 = nn.LayerNorm(embed_dim)
            self.ln2 = nn.LayerNorm(embed_dim)
            self.attn = nn.Attention(embed_dim, num_heads)
            self.ff = nn.Sequential(
                nn.Linear(embed_dim, intermediate),
                nn.GELU(),
                nn.Linear(intermediate, embed_dim),
            )

        def forward(self, x):
            x = self.ln1(x + self.attn(x))
            return self.ln2(x + self.ff(x))

    def __init__(self, embed_dim, num_heads, num_blocks, vocab_size, seq_len, full=True):
        super().__init__()
        self.full = full
        self.embed_dim = embed_dim
        self.seq_len = seq_len
        self.num_blocks = num_blocks
        self.vocab_size = vocab_size
        if full:
            self.tok_embed = nn.Embedding(vocab_size, embed_dim)
            self.register_param("pos_embed", torch.zeros((1, seq_len, embed_dim),
                                                         dtype=torch.float64))
        self.blocks = nn.Sequential(*[Bert.Block(embed_dim, num_heads)
                                      for _ in range(num_blocks)])
        self.ln = nn.LayerNorm(embed_dim)
        if full:
            self.fc = nn.Linear(embed_dim, vocab_size)
            self.softmax = nn.Softmax(-1)

    def embed(self, x):
        """Token ids (encrypted, precision 0, shape (b, t)) -> the embedding
        before its LayerNorm."""
        return self.tok_embed(x) + self._params["pos_embed"][:, : x.shape[1], :]

    def forward(self, x):
        if self.full:
            x = self.embed(x)
        x = self.ln(x)
        for block in self.blocks:
            x = block(x)
        if self.full:
            x = self.softmax(self.fc(x))
        return x


# No GEOM attribute, as in the JAX package: bench.py compresses a model
# class that has one and materializes any other (bench.py:201-226).
class BertTiny(Bert):
    def __init__(self, seq_len, full=True):
        super().__init__(embed_dim=128, num_heads=2, num_blocks=2, vocab_size=30522,
                         seq_len=seq_len, full=full)


class BertBase(Bert):
    def __init__(self, seq_len, full=True):
        super().__init__(embed_dim=768, num_heads=12, num_blocks=12, vocab_size=30522,
                         seq_len=seq_len, full=full)


class BertLarge(Bert):
    def __init__(self, seq_len, full=True):
        super().__init__(embed_dim=1024, num_heads=16, num_blocks=24, vocab_size=30522,
                         seq_len=seq_len, full=full)


def _plain_ln(W, p, x, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * W[f"{p}.weight"] + W[f"{p}.bias"]


def _plain_lin(W, p, x):
    return x @ W[f"{p}.weight"].T + W[f"{p}.bias"]


def plain_blocks(W, x, heads, blocks, prefix="blocks", skip=None, eps=1e-5):
    """float64 post-LN blocks ``prefix.<i>`` of a state dict of tensors on
    x's device, block ``skip`` left out."""
    b, t, d = x.shape
    hd = d // heads
    for i in range(blocks):
        if i == skip:
            continue
        p = f"{prefix}.{i}"
        q, k, v = _plain_lin(W, f"{p}.attn.search", x).split(d, dim=-1)
        q, k, v = (z.reshape(b, t, heads, hd).transpose(1, 2) for z in (q, k, v))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        y = (att @ v).transpose(1, 2).reshape(b, t, d)
        x = _plain_ln(W, f"{p}.ln1", x + _plain_lin(W, f"{p}.attn.proj", y), eps)
        h = _plain_lin(W, f"{p}.ff.0", x)
        h = 0.5 * h * (1 + torch.erf(h / math.sqrt(2)))
        x = _plain_ln(W, f"{p}.ln2", x + _plain_lin(W, f"{p}.ff.2", h), eps)
    return x


def plain_bert_forward(sd, tokens, heads, blocks, device, skip=None, head=True, eps=1e-5):
    """float64 forward of a full ``Bert``'s state dict (numpy arrays or
    tensors under the model's keys): (the last block's output, the
    vocabulary probabilities or None without ``head``); block ``skip`` is
    left out."""
    W = {k: torch.as_tensor(v, dtype=torch.float64, device=device) for k, v in sd.items()}
    ids = torch.as_tensor(tokens, dtype=torch.int64, device=device)
    x = W["tok_embed.weight"][ids] + W["pos_embed"][:, : ids.shape[1]]
    x = plain_blocks(W, _plain_ln(W, "ln", x, eps), heads, blocks, skip=skip, eps=eps)
    probs = torch.softmax(_plain_lin(W, "fc", x), dim=-1) if head else None
    return x, probs
