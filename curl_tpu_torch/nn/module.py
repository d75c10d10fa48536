"""Encrypted nn.Modules (counterpart of ``curl_tpu/nn/module.py``).

Modules are ``torch.nn.Module`` subclasses. Their parameters are held in
their own registry (``register_param``), as plaintext float64 tensors until
``encrypt(src)`` shares them, then as MPCTensors, so that the same
``forward`` runs on encrypted inputs with every party's share stacked on the
leading axis. Buffers (BatchNorm's running statistics) are torch buffers,
public float64 tensors that ``encrypt`` leaves alone. ``state_dict`` holds
both under the JAX package's key names. A module starts in eval mode, as
the JAX package's do (``train()`` switches). Initial values follow the JAX
package's distributions (Linear and Conv weight and bias uniform in
+-1/sqrt(fan_in), Embedding standard normal, LayerNorm and BatchNorm 1 and
0), drawn from the session's explicit torch.Generator.

Seed-compressed parameters (``encrypt(seed_compress=True)``, 2 parties,
inference): each keeps share0 and a key (``mpc/primitives/compressed.py``).
``ChunkedLinear`` holds a weight as equal compressed chunks, one key each,
and runs one product per chunk. The JAX package's ``PrestackedBlocks`` and
its donated ``_write`` are not ported: they keep XLA from stacking the
blocks' parameters inside the compiled graph, which would double the device
memory. Eager PyTorch stacks nothing; ``GPT.build_compressed`` builds,
compresses and frees the blocks one at a time and keeps them as a
``Sequential``, which gives the same peak. ``scan_chunked`` is a loop.
"""

from __future__ import annotations

import contextlib
import math
from collections import OrderedDict

import numpy as np
import torch

from .. import comm
from .. import random as rng
from ..mpc.mpc import MPCTensor
from ..mpc.primitives.compressed import SeedCompressedArithmetic

_init = {"generator": None, "skip": False}


def set_init_seed(seed: int):
    """Restart the parameter-init generator (called by ``init``)."""
    _init["generator"] = torch.Generator().manual_seed(int(seed))


def _generator() -> torch.Generator:
    if _init["generator"] is None:
        set_init_seed(0)
    return _init["generator"]


@contextlib.contextmanager
def skip_init():
    """Construct modules without drawing their initial values (their
    parameters are left uninitialized), for weights installed right after."""
    _init["skip"] = True
    try:
        yield
    finally:
        _init["skip"] = False


def _uniform(shape, bound):
    if _init["skip"]:
        return torch.empty(shape, dtype=torch.float64)
    return (torch.rand(shape, generator=_generator(), dtype=torch.float64) * 2 - 1) * bound


def _normal(shape):
    if _init["skip"]:
        return torch.empty(shape, dtype=torch.float64)
    return torch.randn(shape, generator=_generator(), dtype=torch.float64)


class Parameter:
    """Marks a value as a parameter where it is assigned (module.py:28):
    ``module.name = Parameter(value)`` registers ``value`` as a float64
    tensor, as ``register_param`` does."""

    def __init__(self, value):
        self.value = value


def _param_tensor(value):
    """A plaintext parameter as a float64 tensor (an encrypted one as it is)."""
    if isinstance(value, MPCTensor):
        return value
    if isinstance(value, torch.Tensor):
        return value.detach().to(torch.float64)
    return torch.from_numpy(np.array(value, dtype=np.float64))


class Module(torch.nn.Module):
    """Base module: a registry of plaintext or encrypted parameters."""

    def __init__(self):
        super().__init__()
        self._params = OrderedDict()
        self.training = False

    def register_param(self, name, value):
        if isinstance(value, Parameter):
            value = _param_tensor(value.value)
        self._params[name] = value

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self.register_param(name, value)
        else:
            super().__setattr__(name, value)

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
        """Parameters and buffers by the JAX package's keys."""
        out = OrderedDict(self.named_params(prefix))
        for name, b in self.named_buffers(prefix.rstrip(".")):
            out[name] = b
        return out

    def _plaintext_params(self):
        """(module, name) of every plaintext parameter, in module order."""
        for m in self.modules():
            if isinstance(m, Module):
                for name, p in list(m._params.items()):
                    if isinstance(p, torch.Tensor):
                        yield m, name

    def encrypt(self, src: int = 0, seed_compress: bool = False, requires_grad: bool = False):
        """Share every plaintext parameter from party ``src``;
        ``requires_grad`` marks each as an autograd leaf. The JAX package
        marks every encrypted parameter (module.py:121-127); the port leaves
        an inference model's parameters off the tape unless asked, so that
        a forward records nothing.

        ``seed_compress=True`` (2 parties, inference) keeps seed-compressed
        shares instead (module.py:107-152): each tensor is compressed under
        its own key, folded from one fresh master key, and party 0 holds
        share0 whatever ``src``."""
        from .. import cryptensor

        if seed_compress:
            master = rng.compressed_master(rng.SEED_COMPRESS)
            for n, (m, name) in enumerate(self._plaintext_params()):
                m._params[name] = MPCTensor(
                    SeedCompressedArithmetic.encrypt(m._params[name], rng.fold_in(master, n))
                )
            return self
        for m, name in self._plaintext_params():
            m._params[name] = cryptensor(m._params[name], src=src, requires_grad=requires_grad)
        return self

    def decrypt(self):
        """Every encrypted parameter revealed back into a float64 tensor
        (module.py:154-160)."""
        for m in self.modules():
            if isinstance(m, Module):
                for name, p in list(m._params.items()):
                    if isinstance(p, MPCTensor):
                        m._params[name] = torch.from_numpy(
                            np.array(p.get_plain_text(), dtype=np.float64))
        return self

    def load_state_dict(self, state, strict: bool = True, prefix: str = ""):
        """Install plaintext parameters and buffers by the JAX package's keys
        (module.py:178-197): each parameter becomes a float64 tensor (an
        encrypted one is replaced), each buffer is written; a parameter
        missing from ``state`` raises where ``strict``."""
        def plain(v):
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            return torch.from_numpy(np.array(v, dtype=np.float64))

        for name in list(self._params):
            key = f"{prefix}{name}"
            if key in state:
                self._params[name] = plain(state[key])
            elif strict:
                raise KeyError(key)
        for name, buf in self._buffers.items():
            key = f"{prefix}{name}"
            if key in state and buf is not None:
                self._buffers[name] = plain(state[key])
        for mname, m in self.named_children():
            if isinstance(m, Module):
                m.load_state_dict(state, strict=strict, prefix=f"{prefix}{mname}.")
        return self

    # -- the training surface (module.py:250-275) ---------------------------
    # torch's parameters(), named_parameters() and zero_grad() know nothing
    # of the registry; these read it, with the JAX package's meaning

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        """(dotted name, parameter) of every registered parameter, this
        module's first, then each child's (module.py:91-96)."""
        for name, p in self._params.items():
            yield (f"{prefix}.{name}" if prefix else name), p
        if recurse:
            for mname, m in self.named_children():
                if isinstance(m, Module):
                    yield from m.named_parameters(f"{prefix}.{mname}" if prefix else mname)

    def parameters(self, recurse: bool = True):
        for _, p in self.named_parameters(recurse=recurse):
            yield p

    def zero_grad(self, set_to_none: bool = True):
        """Clear every parameter's accumulated gradient (module.py:250-255):
        ``backward`` adds into ``grad``, so a training loop resets it each
        step."""
        for p in self.parameters():
            if isinstance(p, MPCTensor):
                p.grad = None
        return self

    def update_parameters(self, learning_rate, grad_threshold=100):
        """An SGD step over the encrypted parameters with the reference's
        guard against exploding gradients (module.py:257-275): a gradient
        whose square exceeds ``grad_threshold``^2 is zeroed first. Each
        parameter is replaced by a new leaf that requires grad."""
        from ..autograd import no_grad

        with no_grad():
            for m in self.modules():
                if not isinstance(m, Module):
                    continue
                for name, p in list(m._params.items()):
                    g = getattr(p, "grad", None)
                    if g is None:
                        continue
                    if grad_threshold is not None:
                        g = g.mul(g.square().lt(grad_threshold * grad_threshold))
                    new_p = p.sub(g.mul(learning_rate))
                    new_p.requires_grad = True
                    m._params[name] = new_p
        return self

    # -- functional extraction (the compiled path) --------------------------
    def params_pytree(self):
        """The parameters (plaintext or encrypted; a chunked weight as its
        list of chunks) as a nested dict: this module's under
        ``"__params__"``, each child's under its name."""
        out = {"__params__": dict(self._params)}
        for name, m in self._modules.items():
            if isinstance(m, Module):
                out[name] = m.params_pytree()
        return out

    def bind_params(self, tree):
        """Install a params pytree (``params_pytree``'s structure)."""
        for name, p in tree.get("__params__", {}).items():
            self._params[name] = p
        for name, m in self._modules.items():
            if isinstance(m, Module) and name in tree:
                m.bind_params(tree[name])
        return self

    def functional(self):
        """(apply_fn, params): ``apply_fn(params, *inputs)`` binds the
        parameters and runs ``forward``, the function that
        ``parallel.compile_parties`` captures (binding is Python, so a
        captured graph reads the bound tensors)."""

        def apply_fn(p, *inputs):
            self.bind_params(p)
            return self.forward(*inputs)

        return apply_fn, self.params_pytree()

    def resident_share_bytes(self) -> int:
        """Bytes of the encrypted parameters' shares kept between forwards:
        every party's share of a materialized tensor, share0 and the key of
        a compressed one (chunk lists counted chunk by chunk)."""
        total = 0
        for _, p in self.named_params():
            for t in p if isinstance(p, list) else [p]:
                if isinstance(t, MPCTensor):
                    inner = t._tensor
                    if isinstance(inner, SeedCompressedArithmetic):
                        total += inner.resident_bytes()
                    else:
                        total += inner.share.numel() * inner.share.element_size()
        return total


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

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


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


def _channel_view(p, shape):
    """A per-channel parameter viewed as ``shape`` to broadcast over an
    NC... activation: an encrypted one by ``view``, a plaintext one by
    ``reshape``."""
    return p.view(*shape) if isinstance(p, MPCTensor) else p.reshape(shape)


class _ConvNd(Module):
    """Conv1d / Conv2d (module.py:611-694): weight (O, C/g, *k) and bias
    (O,) uniform in +-1/sqrt(fan_in), fan_in = C/g * prod(k)."""

    _ndim = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True):
        super().__init__()
        k = (kernel_size,) * self._ndim if isinstance(kernel_size, int) else tuple(kernel_size)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        fan_in = in_channels // groups * math.prod(k)
        bound = math.sqrt(1.0 / fan_in)
        self.register_param("weight", _uniform((out_channels, in_channels // groups) + k, bound))
        if bias:
            self.register_param("bias", _uniform((out_channels,), bound))

    def forward(self, x):
        op = "conv%dd" % self._ndim
        out = getattr(x, op)(self._params["weight"], stride=self.stride, padding=self.padding,
                             dilation=self.dilation, groups=self.groups)
        if "bias" in self._params:
            out = out + _channel_view(self._params["bias"], (1, -1) + (1,) * self._ndim)
        return out


class Conv1d(_ConvNd):
    _ndim = 1


class Conv2d(_ConvNd):
    _ndim = 2


class _ConvTransposeNd(Module):
    """Transposed convolution (module.py:697-745): torch's (in, out/g, *k)
    weight layout, fan_in = out * prod(k); groups are refused."""

    _ndim = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, bias=True, dilation=1):
        super().__init__()
        k = (kernel_size,) * self._ndim if isinstance(kernel_size, int) else tuple(kernel_size)
        if groups != 1:
            raise NotImplementedError("grouped conv_transpose not implemented")
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        bound = math.sqrt(1.0 / (out_channels * math.prod(k)))
        self.register_param("weight", _uniform((in_channels, out_channels // groups) + k, bound))
        if bias:
            self.register_param("bias", _uniform((out_channels,), bound))

    def forward(self, x):
        op = "conv_transpose%dd" % self._ndim
        out = getattr(x, op)(self._params["weight"], stride=self.stride, padding=self.padding,
                             output_padding=self.output_padding, dilation=self.dilation,
                             groups=self.groups)
        if "bias" in self._params:
            out = out + _channel_view(self._params["bias"], (1, -1) + (1,) * self._ndim)
        return out


class ConvTranspose1d(_ConvTransposeNd):
    _ndim = 1


class ConvTranspose2d(_ConvTransposeNd):
    _ndim = 2


class Dropout(Module):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return x.dropout(p=self.p, training=self.training)


class Flatten(Module):
    def __init__(self, start_dim=1, end_dim=-1):
        super().__init__()
        self.start_dim = start_dim
        self.end_dim = end_dim

    def forward(self, x):
        return x.flatten(self.start_dim, self.end_dim)


class AvgPool2d(Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return x.avg_pool2d(self.kernel_size, stride=self.stride, padding=self.padding,
                            ceil_mode=self.ceil_mode)


class MaxPool2d(Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return x.max_pool2d(self.kernel_size, stride=self.stride, padding=self.padding,
                            ceil_mode=self.ceil_mode)


class ReLU(Module):
    def forward(self, x):
        return x.relu()


class ReLU6(Module):
    def forward(self, x):
        return x.hardtanh(0, 6)


class GELU(Module):
    def forward(self, x):
        return x.gelu()


class SiLU(Module):
    def forward(self, x):
        return x.silu()


class Sigmoid(Module):
    def forward(self, x):
        return x.sigmoid()


class Tanh(Module):
    def forward(self, x):
        return x.tanh()


class Hardtanh(Module):
    def __init__(self, min_val=-1.0, max_val=1.0):
        super().__init__()
        self.min_val = min_val
        self.max_val = max_val

    def forward(self, x):
        return x.hardtanh(self.min_val, self.max_val)


class Softmax(Module):
    def __init__(self, dim=-1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return x.softmax(self.dim)


class LogSoftmax(Module):
    def __init__(self, dim=-1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return x.log_softmax(self.dim)


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


class _BatchNorm(Module):
    """Batch normalization over the channel axis 1 (module.py:893-923).
    Training normalizes by the batch's private mean and variance (inv_sqrt);
    eval by the public running statistics: (x - running_mean) times the
    public 1 / sqrt(running_var + eps), then the weight and bias, private
    once encrypted. The public statistics enter as host constants, copied
    to the device once."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.register_param("weight", torch.ones((num_features,), dtype=torch.float64))
        self.register_param("bias", torch.zeros((num_features,), dtype=torch.float64))
        self.register_buffer("running_mean", torch.zeros((num_features,), dtype=torch.float64))
        self.register_buffer("running_var", torch.ones((num_features,), dtype=torch.float64))

    def forward(self, x):
        shape = [1] * x.dim()
        shape[1] = self.num_features
        w = _channel_view(self._params["weight"], shape)
        b = _channel_view(self._params["bias"], shape)
        if self.training:
            axes = tuple(i for i in range(x.dim()) if i != 1)
            mean = x.mean(axis=axes, keepdim=True)
            variance = x.var(axis=axes, keepdim=True)
            return (x - mean) * (variance + self.eps).inv_sqrt() * w + b
        rm = self.running_mean.detach().cpu().numpy().reshape(shape)
        inv = 1.0 / (self.running_var.detach().cpu().numpy().reshape(shape) + self.eps) ** 0.5
        return (x - rm) * inv * w + b


class BatchNorm1d(_BatchNorm):
    pass


class BatchNorm2d(_BatchNorm):
    pass


class BatchNorm3d(_BatchNorm):
    pass


class GroupNorm(Module):
    """Group normalization over (C/G, spatial) slices (module.py:926-981):
    each group normalized by its private mean and variance (inv_sqrt),
    then the per-channel affine."""

    def __init__(self, num_groups, num_channels, eps=1e-5, affine=True):
        super().__init__()
        assert num_channels % num_groups == 0, "num_channels must be divisible by num_groups"
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.affine = affine
        if affine:
            self.register_param("weight", torch.ones((num_channels,), dtype=torch.float64))
            self.register_param("bias", torch.zeros((num_channels,), dtype=torch.float64))

    def forward(self, x):
        shape = tuple(x.shape)
        n, c, spatial = shape[0], shape[1], shape[2:]
        g = self.num_groups
        grouped = x.reshape(n, g, (c // g) * math.prod(spatial) or c // g)
        mean = grouped.mean(axis=-1, keepdim=True)
        variance = grouped.var(axis=-1, keepdim=True)
        out = ((grouped - mean) * (variance + self.eps).inv_sqrt()).reshape(*shape)
        if self.affine:
            bshape = (1, c) + (1,) * len(spatial)
            out = out * _channel_view(self._params["weight"], bshape) + _channel_view(
                self._params["bias"], bshape)
        return out


class Embedding(Module):
    """Private embedding via the one-hot protocol (beaver.evaluate_embed)."""

    def __init__(self, vocab_size, embed_dim):
        super().__init__()
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.register_param("weight", _normal((vocab_size, embed_dim)))

    def forward(self, x):
        return x.evaluate_embed(self._params["weight"])


# the causal masks by (seq_len, device): one device copy each
_causal_masks = {}


def causal_mask(seq_len: int, device) -> torch.Tensor:
    """The public lower-triangular (seq_len, seq_len) float64 mask on
    ``device``, made once and kept, so that a forward captured in a CUDA
    graph copies nothing from the host."""
    key = (int(seq_len), str(torch.device(device)))
    if key not in _causal_masks:
        _causal_masks[key] = torch.tril(torch.ones(key[0], key[0], dtype=torch.float64)).to(device)
    return _causal_masks[key]


class Attention(Module):
    """Fused multi-head attention block (module.py:1002-1037).
    ``causal=True`` applies the public lower-triangular mask inside the
    softmax: a position attends to itself and the positions before it."""

    def __init__(self, embed_dim, num_heads, causal=False):
        super().__init__()
        assert embed_dim % num_heads == 0, "invalid heads and embedding dimension"
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.search_dim = embed_dim // num_heads
        self.causal = causal
        self.search = Linear(embed_dim, 3 * embed_dim)
        self.proj = Linear(embed_dim, embed_dim)

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        h, d = self.num_heads, self.search_dim
        query, key, value = self.search(x).split(self.embed_dim, dim=2)
        query = query.reshape(b, t, h, d).transpose(1, 2)
        key = key.reshape(b, t, h, d).permute(0, 2, 3, 1)
        value = value.reshape(b, t, h, d).transpose(1, 2)
        attn = query.matmul(key) / math.sqrt(d)
        mask = causal_mask(t, comm.get_device()) if self.causal else None
        attn = attn.softmax(-1, mask=mask)
        y = attn.matmul(value).transpose(1, 2).reshape(b, t, self.embed_dim)
        return self.proj(y)


def stack_compressed_chunks(weight: torch.Tensor, n_chunks: int, axis: int, master: int):
    """Slice a plaintext ``weight`` into ``n_chunks`` equal chunks along
    ``axis``, zero-padded at the end, and seed-compress each under its own
    key ``fold_in(master, i)`` (module.py:339-374): (chunks as MPCTensors,
    chunk length, padded length)."""
    size = weight.shape[axis]
    cl = -(-size // n_chunks)
    chunks = []
    for i in range(n_chunks):
        lo = min(i * cl, size)
        rows = weight.narrow(axis, lo, min(cl, size - lo))
        if rows.shape[axis] < cl:
            pad = list(weight.shape)
            pad[axis] = cl - rows.shape[axis]
            rows = torch.cat([rows, rows.new_zeros(pad)], dim=axis)
        chunks.append(MPCTensor(SeedCompressedArithmetic.encrypt(rows, rng.fold_in(master, i))))
    return chunks, cl, cl * n_chunks


class ChunkedLinear(Module):
    """Linear over a chunked seed-compressed weight (module.py:377-461).

    ``axis=0`` chunks the output features (the chunks' products
    concatenate); ``axis=1`` chunks the input features (the chunks'
    products, each rescaled, accumulate). Either way a product expands and
    masks one chunk of the weight at a time. Built from a plaintext weight
    (``GPT.build_compressed``); the bias stays a plaintext parameter until
    the enclosing module's ``encrypt``. ``tag`` names the chunks' master
    key (default ``CHUNKED_LINEAR + axis``; the vocab-chunked LM head,
    the JAX package's ChunkedLMHead, passes ``HEAD``)."""

    def __init__(self, weight, bias, n_chunks, axis, tag=None):
        super().__init__()
        self.out_features, self.in_features = weight.shape
        self.n_chunks = n_chunks
        self.axis = axis
        chunks, self.chunk_len, _ = stack_compressed_chunks(
            weight, n_chunks, axis,
            rng.compressed_master(rng.CHUNKED_LINEAR + axis if tag is None else tag)
        )
        self.register_param("wchunks", chunks)
        if bias is not None:
            self.register_param("bias", bias)

    def forward(self, x):
        chunks = self._params["wchunks"]
        if self.axis == 0:
            out = MPCTensor.cat([x.matmul(w.t()) for w in chunks], axis=-1)
            if out.shape[-1] != self.out_features:
                out = out.narrow(-1, 0, self.out_features)
        else:
            cl = self.chunk_len
            pad = self.n_chunks * cl - self.in_features
            if pad:
                x = x.pad((0, pad))
            acc = None
            for i, w in enumerate(chunks):
                part = x.narrow(-1, i * cl, cl).matmul(w.t())
                acc = part if acc is None else acc + part
            out = acc
        if "bias" in self._params:
            out = out + self._params["bias"]
        return out


def splits(n: int, chunk: int) -> bool:
    """Whether ``scan_chunked`` splits ``n`` rows into chunks of ``chunk``:
    a positive multiple of ``chunk`` above it."""
    return 0 < chunk < n and n % chunk == 0


def scan_chunked(fn, x, chunk: int):
    """``fn`` on chunks of ``chunk`` rows of ``x``'s leading axis, the
    results concatenated (module.py:498-538, a loop where the JAX package
    scans; every chunk's draws take fresh counts). A direct call unless
    ``x`` is an MPCTensor whose rows ``splits``."""
    n = x.shape[0] if x.shape else 0
    if not isinstance(x, MPCTensor) or not splits(n, chunk):
        return fn(x)
    return MPCTensor.cat([fn(x[i:i + chunk]) for i in range(0, n, chunk)], axis=0)
