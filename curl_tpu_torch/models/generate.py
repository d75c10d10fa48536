"""Private greedy generation with a causal GPT: the decode loop.

Counterpart of ``examples/generate.py``. The tokens stay encrypted end to
end: the prompt enters as an encrypted one-hot buffer of shape (B, T, V),
each step's token is a private argmax one-hot of the last position's logits,
written back into the buffer at the next position through a public position
mask (a local op), and its embedding on the next step is the private
one-hot buffer times the embedding table, a Beaver matmul. Nothing is
revealed until the caller decodes the buffer.

  * ``build_generator(model, prompt_len, steps)`` returns ``forward(buf)``,
    which Beaver-masks every weight once (``GPT.premask_for_reuse``) and
    runs ``steps`` decode steps; the position masks are public device
    tensors made when the generator is built. ``forward`` is what
    ``parallel.compile_parties`` captures as one CUDA graph, as the JAX
    package compiles its ``lax.scan`` to one program; bind the plain
    weight shares before each call (``Module.functional()``'s
    ``apply_fn`` does), so that each call draws its own masks.
  * ``decode_step(model, buf, sel, wr)`` is one step, returning the new
    buffer and the last position's logits; the generator calls it, and a
    caller that runs the loop eagerly can reveal each step's logits.
  * ``plaintext_replica`` is the same computation in float64 numpy.

The JAX package folds the step index into every key (``rng.fork``) because
one traced ``lax.scan`` body would otherwise draw the same randomness at
every step. The port has no fork: each draw takes a fresh counter from
``random.reserve_counts``, so the steps of an eager loop draw distinct
randomness, and a capture bakes the distinct counters of every step into
its graph.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import comm


def make_masks(prompt_len: int, steps: int, seq_len: int, device=None):
    """(sel, wr): (steps, seq_len) float64 public masks on ``device`` (the
    session's by default); step g reads the logits at position
    prompt_len + g - 1 (``sel``) and writes its token at prompt_len + g
    (``wr``)."""
    if prompt_len < 1 or prompt_len + steps > seq_len:
        raise ValueError(f"prompt {prompt_len} + {steps} steps do not fit {seq_len} positions")
    sel = torch.zeros(steps, seq_len, dtype=torch.float64)
    wr = torch.zeros(steps, seq_len, dtype=torch.float64)
    for g in range(steps):
        sel[g, prompt_len + g - 1] = 1.0
        wr[g, prompt_len + g] = 1.0
    device = comm.get_device() if device is None else device
    return sel.to(device), wr.to(device)


def decode_step(model, buf, sel, wr):
    """One private greedy step (generate.py:51-58): (the buffer with the
    chosen token's one-hot written at ``wr``'s position, the logits at
    ``sel``'s position, (B, V))."""
    t = model.seq_len
    x = buf.matmul(model.tok_embed._params["weight"]) + model._params["pos_embed"]
    for block in model.blocks:
        x = block(x)
    logits = model.fc(model.ln(x))  # (B, T, V)
    last = logits.mul(sel.reshape(1, t, 1)).sum(axis=1)
    nxt = last.argmax(dim=-1, one_hot=True)
    return buf.add(nxt.unsqueeze(1).mul(wr.reshape(1, t, 1))), last


def build_generator(model, prompt_len: int, steps: int):
    """``forward(buf) -> buf`` with ``steps`` tokens generated after the
    first ``prompt_len`` positions (generate.py:33-66); ``forward.masks``
    holds the position masks."""
    sel, wr = make_masks(prompt_len, steps, model.seq_len)

    def forward(buf):
        # every weight is reused at every step: mask each once per call
        model.premask_for_reuse()
        for g in range(steps):
            buf, _ = decode_step(model, buf, sel[g], wr[g])
        return buf

    forward.masks = (sel, wr)
    return forward


def plaintext_logits(sd, buf, num_heads: int, skip=None, causal=True):
    """float64 logits (B, T, V) of the GPT with the numpy state dict ``sd``
    (``load_numpy_state_dict``'s keys) on a one-hot buffer (B, T, V),
    causal unless ``causal=False``; block ``skip`` left out. GELU is the
    tanh form, as in the JAX package's replica."""
    emb = np.asarray(sd["tok_embed.weight"], dtype=np.float64)
    d = emb.shape[1]
    hd = d // num_heads
    t = buf.shape[1]
    keep = np.tril(np.ones((t, t))) if causal else np.ones((t, t))

    def w(key):
        return np.asarray(sd[key], dtype=np.float64)

    def ln(x, p):
        mu = x.mean(-1, keepdims=True)
        var = x.var(-1, keepdims=True)
        return (x - mu) / np.sqrt(var + 1e-5) * w(p + ".weight") + w(p + ".bias")

    def lin(x, p):
        return x @ w(p + ".weight").T + w(p + ".bias")

    x = buf @ emb + w("pos_embed")
    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    for i in range(n_blocks):
        if i == skip:
            continue
        p = f"blocks.{i}"
        q, k, v = np.split(lin(ln(x, p + ".ln1"), p + ".attn.search"), 3, axis=-1)
        b = q.shape[0]
        q = q.reshape(b, t, num_heads, hd).transpose(0, 2, 1, 3)
        k = k.reshape(b, t, num_heads, hd).transpose(0, 2, 3, 1)
        v = v.reshape(b, t, num_heads, hd).transpose(0, 2, 1, 3)
        a = q @ k / np.sqrt(hd)
        a = np.exp(a - a.max(-1, keepdims=True)) * keep
        a = a / np.maximum(a.sum(-1, keepdims=True), 1e-12)
        y = (a @ v).transpose(0, 2, 1, 3).reshape(b, t, d)
        x = x + lin(y, p + ".attn.proj")
        h = lin(ln(x, p + ".ln2"), p + ".ff.0")
        h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi) * (h + 0.044715 * h ** 3)))
        x = x + lin(h, p + ".ff.2")
    return lin(ln(x, "ln"), "fc")


def plaintext_replica(sd, buf, prompt_len: int, steps: int, num_heads: int):
    """The generation in float64 with greedy argmax (generate.py:82-135):
    (the tokens of batch row 0, ``fwd(buf) -> logits``)."""
    buf = np.array(buf, dtype=np.float64)

    def fwd(b):
        return plaintext_logits(sd, b, num_heads)

    toks = []
    for g in range(steps):
        tok = int(fwd(buf)[:, prompt_len + g - 1, :].argmax(-1)[0])
        toks.append(tok)
        buf[0, prompt_len + g, tok] = 1.0
    return toks, fwd
