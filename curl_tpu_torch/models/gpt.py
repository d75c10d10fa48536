"""GPT family for private inference (counterpart of ``curl_tpu/models/gpt.py``).

Pre-LN transformer blocks with the fused Attention module and a GELU FFN,
the private embedding lookup, a final LayerNorm, the LM head and a softmax
over the vocabulary. This slice runs the forward with
``models.head_chunk_positions: 0`` (the shipped config) and materialized
shares; the blocks run as a plain loop where the JAX package scans them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import nn


class GPT(nn.Module):
    class Block(nn.Module):
        def __init__(self, embed_dim, num_heads):
            super().__init__()
            self.ln1 = nn.LayerNorm(embed_dim)
            self.ln2 = nn.LayerNorm(embed_dim)
            self.attn = nn.Attention(embed_dim, num_heads)
            self.ff = nn.Sequential(
                nn.Linear(embed_dim, embed_dim * 4),
                nn.GELU(),
                nn.Linear(embed_dim * 4, embed_dim),
            )

        def forward(self, x):
            x = x + self.attn(self.ln1(x))
            return x + self.ff(self.ln2(x))

    def __init__(self, embed_dim, num_heads, num_blocks, vocab_size, seq_len, full=True):
        super().__init__()
        self.full = full
        self.embed_dim = embed_dim
        self.seq_len = seq_len
        self.num_blocks = num_blocks
        self.vocab_size = vocab_size
        if full:
            self.tok_embed = nn.Embedding(vocab_size, embed_dim)
            self.register_param("pos_embed", torch.zeros((1, seq_len, embed_dim), dtype=torch.float64))
        self.blocks = nn.Sequential(*[GPT.Block(embed_dim, num_heads) for _ in range(num_blocks)])
        if full:
            self.ln = nn.LayerNorm(embed_dim)
            self.fc = nn.Linear(embed_dim, vocab_size)
            self.softmax = nn.Softmax(-1)

    def embed(self, x):
        """Token ids (encrypted, precision 0, shape (b, t)) -> hidden state."""
        tok = self.tok_embed(x)
        return tok + self._params["pos_embed"][:, : x.shape[1], :]

    def forward(self, x):
        if self.full:
            x = self.embed(x)
        for block in self.blocks:
            x = block(x)
        if self.full:
            x = self.softmax(self.fc(self.ln(x)))
        return x


class GPT2(GPT):
    GEOM = dict(embed_dim=768, num_heads=12, num_blocks=12, vocab_size=50257)

    def __init__(self, seq_len, full=True):
        super().__init__(seq_len=seq_len, full=full, **GPT2.GEOM)


def load_numpy_state_dict(model: nn.Module, sd) -> nn.Module:
    """Install a plaintext state dict of numpy arrays, keyed as the JAX
    package's ``Module.state_dict()`` (``tok_embed.weight``, ``pos_embed``,
    ``blocks.<i>.attn.search.weight``, ..., ``fc.weight``), as float64
    parameters. Every key must name a parameter of the same shape, and
    every parameter must be given."""
    own = dict(model.state_dict())
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:5]}, unexpected {extra[:5]}")
    for key, value in sd.items():
        arr = np.asarray(value, dtype=np.float64)
        if tuple(arr.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(own[key].shape)}")
        *path, name = key.split(".")
        mod = model
        for part in path:
            mod = getattr(mod, part)
        mod._params[name] = torch.from_numpy(arr.copy())
    return model
