"""curl_tpu_torch — the PyTorch/CUDA port of curl_tpu.

Secure multi-party computation with Curl's wavelet-LUT nonlinearities, on
PyTorch and hand-written CUDA kernels for one NVIDIA Hopper card:

  * shares are ``(P, ...)`` torch.int64 tensors with every party's share on
    the leading axis (simulated parties on one device); reveals reduce over
    that axis (``comm``);
  * every exact ring matmul runs in the ``ring_mm`` CUDA kernel, every bulk
    random draw and sharing in the ``philox`` CUDA kernel
    (``kernels/``, ``csrc/``); CPU tensors take their plain torch versions.

    import curl_tpu_torch as ct
    ct.init(world_size=2, seed=0)          # on the CUDA card
    x = ct.cryptensor([1.0, -2.0])
    x.gelu().get_plain_text()

    apply_fn, params = model.functional()
    step = ct.compile_parties(apply_fn, 2)   # a captured CUDA graph
    out = step(seed, params, xe)              # fresh randomness per seed

Training (define-by-run autograd over the shares, ``autograd.py`` and
``gradients.py``):

    model.encrypt(src=0, requires_grad=True)
    opt = ct.optim.SGD(model.parameters(), lr=0.01)
    opt.zero_grad()
    loss = ct.nn.CrossEntropyLoss()(model(xe), labels)
    loss.backward()
    opt.step()

    online, fill = ct.compile_parties_cached(apply_fn, 2, 99, params, xe)
    cache = fill(97)                          # the offline phase: every tuple
    out = online(101, cache, params, xe)      # the online phase, served

Eager ops serve from a host cache too: ``trace(True)`` records the tuple
requests of the ops that follow, ``fill_cache()`` generates them, and the
same ops run again pop its entries in order.

Eager ops in a lazy scope are recorded and run as one program, a captured
CUDA graph on the card, at the first read of a result (``lazy.py``):

    with ct.lazy():
        h = model(xe)
    h.get_plain_text()

A profile replaces the whole config: ``ct.init(config_file=
ct.config.profile("llm_config"))`` (or any YAML file of the same keys).

The package imports no JAX and nothing of ``curl_tpu``.
"""

from __future__ import annotations

import builtins
import logging

import torch

from . import comm
from . import random as _rng
from . import lazy as _lazy
from .config import cfg
from .encoder import FixedPointEncoder
from .mpc import MPCTensor, get_default_provider  # noqa: F401
from .mpc.ptype import ptype
from . import functions  # noqa: F401  (installs ops on MPCTensor)
from . import gradients as _gradients
from .autograd import enable_grad, is_grad_enabled, no_grad  # noqa: F401

_gradients.install()  # the autograd dispatch, over the ops functions installed
from . import nn  # noqa: F401
from . import models  # noqa: F401
from .nn import module as _nn_module
from . import parallel  # noqa: F401
from .parallel import Public, compile_parties, compile_parties_cached, run_parties  # noqa: F401
from . import optim  # noqa: F401
from .lazy import lazy  # noqa: F401

__version__ = "0.1.0"

# the port's encrypted tensor: every party's share already stacked
CrypTensor = MPCTensor

_initialized = False


def init(config_file=None, world_size: int = 2, seed: int = 0, device=None):
    """Start a session (curl_tpu/__init__.py:93-118): load the profile
    ``config_file`` where given (it replaces the whole config), derive the
    party streams from ``seed``, restart the draw counter, the flush seeds
    of the lazy scope and the parameter-init generator, and build the
    lookup tables the config's methods use.

    ``device=None`` runs on the CUDA card and raises where there is none;
    only an explicit ``device="cpu"`` runs on the CPU."""
    global _initialized
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "curl_tpu_torch.init: no CUDA device; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    if config_file is not None:
        cfg.load_config(config_file)
    comm.set_device(device)
    comm.set_world_size(world_size)
    _rng.set_keys(_rng.make_party_keys(seed, world_size))
    if comm.get_device().type == "cuda":
        _rng.TABLE.tensor(comm.get_device())  # the key table's device copy
    _rng.reset_count()
    _lazy.reset(seed)
    _nn_module.set_init_seed(seed)
    from .functions.luts import LookupTables

    LookupTables().build_all()
    _initialized = True


def uninit():
    """End the session: its keys are dropped, and ops raise until the next
    ``init`` (curl_tpu/__init__.py:121-123)."""
    global _initialized
    _initialized = False
    _rng.clear_keys()
    _lazy.reset()


def is_initialized() -> bool:
    return _initialized


def init_thread(rank=None, world_size: int = 2, seed: int = 0, device=None):
    """The reference's thread-based in-process mode (curl/__init__.py:84;
    curl_tpu/__init__.py:634): the parties are the shares' leading axis of
    one process, so this is ``init``."""
    return init(world_size=world_size, seed=seed, device=device)


def cryptensor(value, src: int = 0, precision=None, ptype_=ptype.arithmetic,
               requires_grad: bool = False) -> MPCTensor:
    """Encrypt a plaintext held by party ``src``; ``requires_grad`` marks
    the result as an autograd leaf (curl_tpu/__init__.py:453-467)."""
    out = MPCTensor.encrypt(value, src=src, precision=precision, ptype=ptype_)
    if requires_grad:
        out.requires_grad = True
    return out


def _sequence_op(name, tensors, dim):
    """cat or stack of encrypted tensors, public ones encrypted first; on
    the tape where grad mode is on and one requires grad
    (curl_tpu/__init__.py:474-500)."""
    from . import autograd

    tensors = [t if isinstance(t, MPCTensor) else cryptensor(t) for t in tensors]
    if autograd.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return autograd.apply_function(name, tensors, dim)
    return getattr(MPCTensor, name)(tensors, axis=dim)


def cat(tensors, dim=0) -> MPCTensor:
    """Concatenate encrypted tensors along ``dim``."""
    return _sequence_op("cat", tensors, dim)


def stack(tensors, dim=0) -> MPCTensor:
    """Stack encrypted tensors along a new ``dim``."""
    return _sequence_op("stack", tensors, dim)


def where(condition, x, y):
    """``x`` where ``condition`` is 1, else ``y`` (curl_tpu/__init__.py:502-508):
    a private 0/1 condition by two private products; a public one by public
    products with the private operands; all public, torch.where."""
    from .mpc.primitives.arithmetic import _public_tensor

    if isinstance(condition, MPCTensor):
        return condition.mul(x).add(condition.neg().add(1).mul(y))
    cond = _public_tensor(condition, constant=True).to(torch.float64)
    if isinstance(x, MPCTensor):
        return x.mul(cond).add(y.mul(1 - cond) if isinstance(y, MPCTensor)
                               else _public_tensor(y).to(torch.float64) * (1 - cond))
    if isinstance(y, MPCTensor):
        return y.mul(1 - cond).add(_public_tensor(x).to(torch.float64) * cond)
    return torch.where(cond != 0, _public_tensor(x), _public_tensor(y))


def _sizes(sizes):
    return tuple(sizes[0]) if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)) else sizes


def rand(*sizes) -> MPCTensor:
    """Private uniform [0, 1) samples (curl_tpu/__init__.py:511)."""
    return MPCTensor.rand(*_sizes(sizes))


def randn(*sizes) -> MPCTensor:
    """Private standard normal samples by Box-Muller (curl_tpu/__init__.py:519)."""
    return MPCTensor.randn(*_sizes(sizes))


def bernoulli(tensor) -> MPCTensor:
    """Private draws that are 1 with the public probabilities ``tensor``
    (curl_tpu/__init__.py:526)."""
    import numpy as np

    return rand(*np.shape(tensor)).lt(tensor)


def is_encrypted_tensor(obj) -> bool:
    return isinstance(obj, MPCTensor)


def get_communication_stats():
    return comm.get_communication_stats()


def reset_communication_stats():
    comm.reset_communication_stats()


def print_communication_stats():
    """Rounds, bytes and calls through ``logging.info``
    (curl_tpu/__init__.py:577)."""
    comm.print_communication_stats()


def log(*args, **kwargs):
    """``logging.info`` (curl_tpu/__init__.py:585)."""
    logging.info(*args, **kwargs)


def print(*args, dst=0, **kwargs):  # noqa: A001  (the reference's curl.print)
    """Rank-aware print (curl_tpu/__init__.py:640): the simulated parties
    share one process, which plays the ``dst`` role."""
    builtins.print(*args, **kwargs)


def print_in_order(*args, **kwargs):
    """Print once for all parties (curl_tpu/__init__.py:649): one process
    holds them all."""
    builtins.print(*args, **kwargs)


# tuple-cache controls (curl/__init__.py:582-591; curl_tpu/__init__.py:591-615)

def trace(tracing: bool = True):
    """Record the tuple request of every provider call from now on."""
    get_default_provider().trace(tracing)


def trace_once():
    """Record only if nothing has been recorded yet."""
    get_default_provider().trace_once()


def fill_cache(seed=0):
    """The offline phase for eager ops: every recorded request generated
    under the session's keys from the session's draw counter, attached as
    the host cache, from which the eager ops that follow pop their tuples
    in order. ``seed`` is not read: curl_tpu's fill draws under its
    session's fresh keys too."""
    from .mpc.provider.provider import TupleCache

    provider = get_default_provider()
    _rng.current_keys()  # raises before init
    cache = TupleCache(provider.fill_cache_entries(), funcs=[r.func for r in provider.requests])
    provider.attach_cache(cache)
    return cache
