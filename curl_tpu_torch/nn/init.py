"""Weight initialization (counterpart of ``curl_tpu/nn/init.py``; the
reference's curl/nn/init.py).

Each function returns a float64 tensor of ``shape``. The JAX package
draws from JAX keys folded from a global counter; the port draws from the
session's explicit ``torch.Generator`` (``init`` seeds it, as it seeds the
modules' initial values), so the values differ and the fans and
distributions agree.
"""

from __future__ import annotations

import math

import torch

from .module import _generator


def uniform_(shape, a=0.0, b=1.0):
    return torch.rand(shape, generator=_generator(), dtype=torch.float64) * (b - a) + a


def normal_(shape, mean=0.0, std=1.0):
    return torch.randn(shape, generator=_generator(), dtype=torch.float64) * std + mean


def constant_(shape, val):
    return torch.full(tuple(shape), float(val), dtype=torch.float64)


def ones_(shape):
    return torch.ones(shape, dtype=torch.float64)


def zeros_(shape):
    return torch.zeros(shape, dtype=torch.float64)


def _fan(shape):
    """(fan_in, fan_out) of a weight: a matrix (out, in) or a kernel
    (out, in, *k)."""
    if len(shape) == 2:
        fan_in, fan_out = shape[1], shape[0]
    else:
        rf = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * rf, shape[0] * rf
    return fan_in, fan_out


def xavier_uniform_(shape, gain=1.0):
    fan_in, fan_out = _fan(shape)
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return uniform_(shape, -a, a)


def xavier_normal_(shape, gain=1.0):
    fan_in, fan_out = _fan(shape)
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return normal_(shape, 0.0, std)


def kaiming_uniform_(shape, a=0, mode="fan_in"):
    fan_in, fan_out = _fan(shape)
    fan = fan_in if mode == "fan_in" else fan_out
    gain = math.sqrt(2.0 / (1 + a ** 2))
    bound = gain * math.sqrt(3.0 / fan)
    return uniform_(shape, -bound, bound)


def kaiming_normal_(shape, a=0, mode="fan_in"):
    fan_in, fan_out = _fan(shape)
    fan = fan_in if mode == "fan_in" else fan_out
    gain = math.sqrt(2.0 / (1 + a ** 2))
    return normal_(shape, 0.0, gain / math.sqrt(fan))
