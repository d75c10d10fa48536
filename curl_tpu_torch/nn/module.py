"""Encrypted nn.Modules (counterpart of ``curl_tpu/nn/module.py``).

Modules are ``torch.nn.Module`` subclasses. Their parameters are held in
their own registry (``register_param``), as plaintext float64 tensors until
``encrypt(src)`` shares them, then as MPCTensors, so that the same
``forward`` runs on encrypted inputs with every party's share stacked on the
leading axis. ``state_dict`` uses the JAX package's key names. Initial
values follow the JAX package's distributions (Linear weight and bias
uniform in +-1/sqrt(fan_in), Embedding standard normal, LayerNorm 1 and 0),
drawn from the session's explicit torch.Generator.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch

from ..mpc.mpc import MPCTensor

_init = {"generator": None}


def set_init_seed(seed: int):
    """Restart the parameter-init generator (called by ``init``)."""
    _init["generator"] = torch.Generator().manual_seed(int(seed))


def _generator() -> torch.Generator:
    if _init["generator"] is None:
        set_init_seed(0)
    return _init["generator"]


def _uniform(shape, bound):
    return (torch.rand(shape, generator=_generator(), dtype=torch.float64) * 2 - 1) * bound


class Module(torch.nn.Module):
    """Base module: a registry of plaintext or encrypted parameters."""

    def __init__(self):
        super().__init__()
        self._params = OrderedDict()

    def register_param(self, name, value):
        self._params[name] = value

    def __getattr__(self, name):
        params = self.__dict__.get("_params")
        if params is not None and name in params:
            return params[name]
        return super().__getattr__(name)

    def named_params(self, prefix=""):
        for name, p in self._params.items():
            yield f"{prefix}{name}", p
        for mname, m in self.named_children():
            if isinstance(m, Module):
                yield from m.named_params(f"{prefix}{mname}.")

    def state_dict(self, prefix=""):
        return OrderedDict(self.named_params(prefix))

    def encrypt(self, src: int = 0):
        """Share every plaintext parameter from party ``src``."""
        from .. import cryptensor

        for m in self.modules():
            if isinstance(m, Module):
                for name, p in list(m._params.items()):
                    if not isinstance(p, MPCTensor):
                        m._params[name] = cryptensor(p, src=src)
        return self


class Sequential(Module):
    def __init__(self, *modules):
        super().__init__()
        for i, m in enumerate(modules):
            self.add_module(str(i), m)

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x

    def __iter__(self):
        return iter(self._modules.values())


class Linear(Module):
    """y = x W^T + b."""

    def __init__(self, in_features, out_features, bias=True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        bound = math.sqrt(1.0 / in_features)
        self.register_param("weight", _uniform((out_features, in_features), bound))
        if bias:
            self.register_param("bias", _uniform((out_features,), bound))

    def forward(self, x):
        out = x.matmul(self._params["weight"].t())
        if "bias" in self._params:
            out = out + self._params["bias"]
        return out


class GELU(Module):
    def forward(self, x):
        return x.gelu()


class Softmax(Module):
    def __init__(self, dim=-1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return x.softmax(self.dim)


def layernorm(x, weight, bias, eps=1e-5, dims=1):
    """(x - mean) * inv_sqrt(var + eps) * weight + bias over trailing dims."""
    axes = tuple(range(x.dim() - dims, x.dim()))
    mean = x.mean(axis=axes, keepdim=True)
    variance = x.var(axis=axes, keepdim=True)
    inv_var = (variance + eps).inv_sqrt()
    out = (x - mean) * inv_var
    return out * weight + bias


class LayerNorm(Module):
    def __init__(self, normalized_shape, eps=1e-5):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.register_param("weight", torch.ones(self.normalized_shape, dtype=torch.float64))
        self.register_param("bias", torch.zeros(self.normalized_shape, dtype=torch.float64))

    def forward(self, x):
        return layernorm(
            x, self._params["weight"], self._params["bias"], eps=self.eps,
            dims=len(self.normalized_shape),
        )


class Embedding(Module):
    """Private embedding via the one-hot protocol (beaver.evaluate_embed)."""

    def __init__(self, vocab_size, embed_dim):
        super().__init__()
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.register_param(
            "weight",
            torch.randn((vocab_size, embed_dim), generator=_generator(), dtype=torch.float64),
        )

    def forward(self, x):
        return x.evaluate_embed(self._params["weight"])


class Attention(Module):
    """Fused multi-head attention block (non-causal, as the reference's)."""

    def __init__(self, embed_dim, num_heads):
        super().__init__()
        assert embed_dim % num_heads == 0, "invalid heads and embedding dimension"
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.search_dim = embed_dim // num_heads
        self.search = Linear(embed_dim, 3 * embed_dim)
        self.proj = Linear(embed_dim, embed_dim)

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        h, d = self.num_heads, self.search_dim
        query, key, value = self.search(x).split(self.embed_dim, dim=2)
        query = query.reshape(b, t, h, d).transpose(1, 2)
        key = key.reshape(b, t, h, d).permute(0, 2, 3, 1)
        value = value.reshape(b, t, h, d).transpose(1, 2)
        attn = (query.matmul(key) / math.sqrt(d)).softmax(-1)
        y = attn.matmul(value).transpose(1, 2).reshape(b, t, self.embed_dim)
        return self.proj(y)
