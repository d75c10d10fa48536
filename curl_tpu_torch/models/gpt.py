"""GPT family for private inference (counterpart of ``curl_tpu/models/gpt.py``).

Pre-LN transformer blocks with the fused Attention module and a GELU FFN,
the private embedding lookup, a final LayerNorm, the LM head and a softmax
over the vocabulary. The blocks run as a plain loop where the JAX package
scans them. ``causal=True`` masks the attention causally, as a served
(generating) GPT does. ``GPT.build_compressed`` builds the seed-compressed
model that bench.py runs (GPT-2, and GPT-Neo 1.3B's and 2.7B's
geometries): vocab-chunked embedding and LM head, and at 1024 wide and
above chunked block linears.
``models.head_chunk_positions`` runs the embedding and the head over chunks
of positions; a materialized embedding table and LM-head weight are then
Beaver-masked once a forward (``_premask_linear``) and reused by every
chunk. ``premask_for_reuse`` masks every weight, for a decode loop
(``models/generate.py``). ``load_hf_state_dict`` maps a HuggingFace GPT-2
state dict onto the model.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import nn
from .. import random as rng
from ..config import cfg
from ..lazy import call as lazy_call
from ..mpc.mpc import MPCTensor
from ..mpc.primitives import beaver
from ..mpc.primitives.arithmetic import ArithmeticSharedTensor


class ChunkedEmbedding(nn.Module):
    """Embedding over a vocab-sliced seed-compressed table (gpt.py:75): the
    one-hot is built once over the padded vocabulary, then one Beaver
    product per slice (``beaver.evaluate_embed_chunked``)."""

    def __init__(self, weight, n_chunks):
        super().__init__()
        self.vocab, self.embed_dim = weight.shape
        chunks, _, self.v_pad = nn.module.stack_compressed_chunks(
            weight, n_chunks, 0, rng.compressed_master(rng.EMBED)
        )
        self.register_param("tchunks", chunks)

    def forward(self, x):
        return lazy_call(_embed_chunked, x, self._params["tchunks"], self.vocab, self.embed_dim)


def _embed_chunked(x, tchunks, vocab, embed_dim):
    """The private embedding of ``x`` over the table's vocab slices (one op
    of a lazy scope)."""
    chunks = [t._tensor for t in tchunks]
    out = beaver.evaluate_embed_chunked(x._tensor, chunks, vocab, embed_dim)
    return MPCTensor(ArithmeticSharedTensor(out.share, chunks[0].encoder))


def _install(module, sd, prefix="", keys=None):
    """Install ``sd[prefix + key]`` (numpy arrays) as the float64 parameter
    or buffer ``key`` of ``module``, for each of ``keys`` (default: every
    key of the module's state dict)."""
    params = module.state_dict()
    for key in params if keys is None else keys:
        own = params[key]
        arr = np.asarray(sd[prefix + key], dtype=np.float64)
        if tuple(arr.shape) != tuple(own.shape):
            raise ValueError(f"{prefix + key}: shape {arr.shape} != {tuple(own.shape)}")
        *path, name = key.split(".")
        mod = module
        for part in path:
            mod = getattr(mod, part)
        store = mod._buffers if name in mod._buffers else mod._params
        store[name] = torch.from_numpy(np.array(arr))


class GPT(nn.Module):
    class Block(nn.Module):
        def __init__(self, embed_dim, num_heads, causal=False):
            super().__init__()
            self.ln1 = nn.LayerNorm(embed_dim)
            self.ln2 = nn.LayerNorm(embed_dim)
            self.attn = nn.Attention(embed_dim, num_heads, causal=causal)
            self.ff = nn.Sequential(
                nn.Linear(embed_dim, embed_dim * 4),
                nn.GELU(),
                nn.Linear(embed_dim * 4, embed_dim),
            )

        def forward(self, x):
            x = x + self.attn(self.ln1(x))
            return x + self.ff(self.ln2(x))

    def __init__(self, embed_dim, num_heads, num_blocks, vocab_size, seq_len, full=True,
                 causal=False):
        super().__init__()
        self.full = full
        self.embed_dim = embed_dim
        self.seq_len = seq_len
        self.num_blocks = num_blocks
        self.vocab_size = vocab_size
        if full:
            self.tok_embed = nn.Embedding(vocab_size, embed_dim)
            self.register_param("pos_embed", torch.zeros((1, seq_len, embed_dim), dtype=torch.float64))
        self.blocks = nn.Sequential(*[GPT.Block(embed_dim, num_heads, causal=causal)
                                      for _ in range(num_blocks)])
        if full:
            self.ln = nn.LayerNorm(embed_dim)
            self.fc = nn.Linear(embed_dim, vocab_size)
            self.softmax = nn.Softmax(-1)

    @staticmethod
    def _head_chunk() -> int:
        """cfg.models.head_chunk_positions: positions per chunk of the
        embedding and LM-head stages (0 = off)."""
        try:
            return int(cfg.models.head_chunk_positions)
        except (AttributeError, TypeError, ValueError):
            return 0

    @staticmethod
    def _premask_linear(module):
        """Replace a module's materialized encrypted weight with its
        Beaver-masked form (gpt.py:218-240); a no-op on a plaintext,
        compressed or already masked weight, and where ``mask_operand``
        declines."""
        w = module._params.get("weight")
        if not isinstance(w, MPCTensor) or type(w._tensor) is not ArithmeticSharedTensor:
            return
        masked = beaver.mask_operand(w._tensor)
        if masked is not w._tensor:
            module._params["weight"] = MPCTensor(masked)

    def premask_for_reuse(self):
        """Beaver-mask every weight a decode loop reuses (gpt.py:242-253):
        the embedding table, the LM head and each block's linears. Each
        product then draws only input-sized randomness. A mask is drawn
        where this is called: call it inside the function a runner
        captures, after binding the plain shares, so that every call draws
        its own."""
        if self.full:
            self._premask_linear(self.tok_embed)
            self._premask_linear(self.fc)
        for blk in self.blocks:
            for lin in (blk.attn.search, blk.attn.proj, blk.ff._modules["0"],
                        blk.ff._modules["2"]):
                self._premask_linear(lin)
        return self

    def embed(self, x):
        """Token ids (encrypted, precision 0, shape (b, t)) -> hidden state.
        Where the ids split into chunks of positions, the table is masked
        once and every chunk reuses it."""
        if x.dim() == 2:
            b, t = x.shape
            chunk = self._head_chunk()
            if nn.module.splits(b * t, chunk):
                self._premask_linear(self.tok_embed)
            tok = nn.module.scan_chunked(self.tok_embed, x.reshape(b * t), chunk)
            tok = tok.reshape(b, t, self.embed_dim)
        else:
            tok = self.tok_embed(x)
        return tok + self._params["pos_embed"][:, : x.shape[1], :]

    def forward(self, x):
        if self.full:
            x = self.embed(x)
        for block in self.blocks:
            x = block(x)
        if self.full:
            b, t, d = x.shape
            chunk = self._head_chunk()
            if nn.module.splits(b * t, chunk):
                # every chunk of positions reuses the head's weight
                self._premask_linear(self.fc)

            def head(rows):
                return self.softmax(self.fc(self.ln(rows)))

            x = nn.module.scan_chunked(head, x.reshape(b * t, d), chunk)
            x = x.reshape(b, t, self.vocab_size)
        return x

    @classmethod
    def build_compressed(cls, embed_dim, num_heads, num_blocks, vocab_size, seq_len,
                         causal=False, head_vocab_chunks=8, chunk_block_linears=None,
                         state_dict=None):
        """An encrypted GPT whose parameters are seed-compressed and never
        all materialize (gpt.py:257-363).

        ``state_dict``: plaintext numpy arrays under the materialized
        model's keys (``load_numpy_state_dict``'s), any mapping; without
        one, the weights are drawn in the JAX package's distributions from
        the session's generator. Each block is built, compressed and its
        plaintext freed in turn, so peak memory stays about one block's
        plaintext above the final footprint. The LM head and the embedding
        take ``head_vocab_chunks`` vocab slices (a ``ChunkedLinear`` over
        output features, the JAX package's ChunkedLMHead, and
        ``ChunkedEmbedding``); ``chunk_block_linears`` (default: at 1024
        wide and above) replaces each block's QKV and FFN linears with
        ``ChunkedLinear``s of (d, d) chunks."""
        sd = state_dict
        d = embed_dim
        if chunk_block_linears is None:
            # at 1024 wide and above the (d, 4d) weights' Beaver transients
            # are taken one (d, d) chunk at a time
            chunk_block_linears = embed_dim >= 1024
        no_init = nn.module.skip_init if sd is not None else contextlib.nullcontext
        if sd is not None:
            with no_init():
                block_keys = list(GPT.Block(d, num_heads, causal=causal).state_dict())
            want = {"tok_embed.weight", "pos_embed", "ln.weight", "ln.bias", "fc.weight",
                    "fc.bias"}
            want |= {f"blocks.{i}.{k}" for i in range(num_blocks) for k in block_keys}
            missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
            if missing or extra:
                raise KeyError(f"state dict mismatch: missing {missing[:5]}, "
                               f"unexpected {extra[:5]}")

        model = GPT(d, num_heads, 0, vocab_size, seq_len, full=False, causal=causal)
        model.full = True
        model.num_blocks = num_blocks

        for i in range(num_blocks):
            with no_init():
                blk = GPT.Block(d, num_heads, causal=causal)
            if sd is not None:
                _install(blk, sd, f"blocks.{i}.")
            if chunk_block_linears:
                _chunk_block_linears(blk)
            blk.encrypt(seed_compress=True)
            model.blocks.add_module(str(i), blk)

        with no_init():
            model.fc = nn.Linear(d, vocab_size)
            model.tok_embed = nn.Embedding(vocab_size, d)
            model.ln = nn.LayerNorm(d)
        model.register_param("pos_embed", torch.zeros((1, seq_len, d), dtype=torch.float64))
        if sd is not None:
            # in state-dict order within each part: a mapping that makes its
            # arrays part by part makes each part once
            for name in ("fc", "ln", "tok_embed"):
                _install(getattr(model, name), sd, f"{name}.")
            _install(model, sd, keys=["pos_embed"])
        fc = model.fc._params
        model.fc = nn.module.ChunkedLinear(fc["weight"], fc["bias"], head_vocab_chunks, 0,
                                           tag=rng.HEAD)
        model.tok_embed = ChunkedEmbedding(model.tok_embed._params["weight"], head_vocab_chunks)
        model.softmax = nn.Softmax(-1)
        # the rest (pos_embed, the final LayerNorm, the head's bias)
        return model.encrypt(seed_compress=True)


def _chunk_block_linears(blk):
    """Replace a block's QKV and FFN linears with ChunkedLinears of (d, d)
    chunks (gpt.py:309-332): the QKV (3 chunks) and the FFN up projection
    (4) by output features, the FFN down projection (4) by input features."""
    def chunked(lin, n, axis):
        return nn.module.ChunkedLinear(lin._params["weight"], lin._params.get("bias"), n, axis)

    blk.attn.search = chunked(blk.attn.search, 3, 0)
    blk.ff._modules["0"] = chunked(blk.ff._modules["0"], 4, 0)
    blk.ff._modules["2"] = chunked(blk.ff._modules["2"], 4, 1)


class GPT2(GPT):
    GEOM = dict(embed_dim=768, num_heads=12, num_blocks=12, vocab_size=50257)

    def __init__(self, seq_len, full=True, causal=False):
        super().__init__(seq_len=seq_len, full=full, causal=causal, **GPT2.GEOM)


class GPTNeo(GPT):
    """GPT-Neo 1.3B's geometry (gpt.py:420-426); built compressed."""

    GEOM = dict(embed_dim=2048, num_heads=16, num_blocks=24, vocab_size=50257)

    def __init__(self, seq_len, full=True, causal=False):
        super().__init__(seq_len=seq_len, full=full, causal=causal, **GPTNeo.GEOM)


class GPTNeoLarge(GPT):
    """GPT-Neo 2.7B's geometry (gpt.py:429-435); built compressed."""

    GEOM = dict(embed_dim=2560, num_heads=20, num_blocks=32, vocab_size=50257)

    def __init__(self, seq_len, full=True, causal=False):
        super().__init__(seq_len=seq_len, full=full, causal=causal, **GPTNeoLarge.GEOM)


def load_numpy_state_dict(model: nn.Module, sd) -> nn.Module:
    """Install a plaintext state dict of numpy arrays, keyed as the JAX
    package's ``Module.state_dict()`` (``tok_embed.weight``, ``pos_embed``,
    ``blocks.<i>.attn.search.weight``, ..., ``fc.weight``; a ResNet's
    torchvision keys, BatchNorm's running statistics included), as float64
    parameters and buffers. Every key must name a parameter or buffer of
    the same shape, and every one must be given."""
    own = dict(model.state_dict())
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:5]}, unexpected {extra[:5]}")
    _install(model, sd)
    return model


def load_hf_state_dict(model: GPT, sd) -> GPT:
    """Map a HuggingFace ``GPT2LMHeadModel`` (or bare ``GPT2Model``) state
    dict, a mapping of tensors or arrays, onto a full plaintext ``model``
    (gpt.py:366-408). HF's Conv1D layers store their weights (in, out)
    where a Linear stores (out, in), so c_attn, c_proj and c_fc are
    transposed; the LM head is tied to ``wte`` (``lm_head.weight`` where
    given) with a zero bias."""
    if not model.full:
        raise ValueError("load_hf_state_dict needs the full model (full=True)")

    def g(key):
        t = sd[key]
        arr = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
        return torch.from_numpy(np.array(arr, dtype=np.float64))

    pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    model.tok_embed._params["weight"] = g(pfx + "wte.weight")
    model._params["pos_embed"] = g(pfx + "wpe.weight")[None, : model.seq_len].clone()
    for i, blk in enumerate(model.blocks):
        p = f"{pfx}h.{i}."
        for ln, name in ((blk.ln1, "ln_1"), (blk.ln2, "ln_2")):
            ln._params["weight"] = g(p + name + ".weight")
            ln._params["bias"] = g(p + name + ".bias")
        for lin, name in ((blk.attn.search, "attn.c_attn"), (blk.attn.proj, "attn.c_proj"),
                          (blk.ff._modules["0"], "mlp.c_fc"), (blk.ff._modules["2"], "mlp.c_proj")):
            lin._params["weight"] = g(p + name + ".weight").T.contiguous()
            lin._params["bias"] = g(p + name + ".bias")
    model.ln._params["weight"] = g(pfx + "ln_f.weight")
    model.ln._params["bias"] = g(pfx + "ln_f.bias")
    head_key = "lm_head.weight" if "lm_head.weight" in sd else pfx + "wte.weight"
    model.fc._params["weight"] = g(head_key)
    model.fc._params["bias"] = torch.zeros(model.vocab_size, dtype=torch.float64)
    return model
