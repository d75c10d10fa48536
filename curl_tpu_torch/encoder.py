"""Fixed-point encoder: float <-> scaled int64 ring elements.

Counterpart of ``curl_tpu/encoder.py``: scale = 2^precision_bits, encode
multiplies and truncates toward zero (the reference's ``(scale * x).long()``),
decode divides the signed view on the host in numpy float64.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from . import ring
from .config import cfg


def nearest_integer_division(tensor, integer: int):
    """Round-to-nearest division of a signed numpy int64 array."""
    assert integer > 0
    t = np.asarray(tensor).astype(np.int64)
    lez = (t < 0).astype(np.int64)
    pos_rem = (1 - lez) * np.mod(t, integer)
    neg_rem = lez * np.mod(integer - t, integer)
    rem = pos_rem + neg_rem
    quot = np.sign(t) * (np.abs(t) // integer)
    corr = (2 * rem > integer).astype(np.int64)
    return quot + np.sign(t) * corr


class FixedPointEncoder:
    """Encodes/decodes to the 2^-precision fixed-point representation."""

    def __init__(self, precision_bits=None):
        if precision_bits is None:
            precision_bits = cfg.encoder.precision_bits
        self._precision_bits = int(precision_bits)

    @property
    def scale(self) -> int:
        return 1 << self._precision_bits

    @property
    def precision_bits(self) -> int:
        return self._precision_bits

    def encode(self, x):
        """Python scalars -> Python int (in the int64 range); arrays and
        tensors -> int64 tensor on the tensor's device."""
        if isinstance(x, (bool, np.bool_)):
            x = int(x)
        if isinstance(x, numbers.Integral):
            return ring.scalar(int(x) * self.scale)
        if isinstance(x, numbers.Real):
            return ring.scalar(int(x * self.scale))
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if x.dtype == np.uint64:
                x = x.view(np.int64)
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.dtype.is_floating_point:
            # (scale * x).long(): C-style truncation, in float64
            return torch.trunc(x.to(torch.float64) * float(self.scale)).to(torch.int64)
        if not x.dtype.is_complex:
            return x.to(torch.int64) * self.scale
        raise TypeError(f"cannot encode dtype {x.dtype}")

    def decode(self, tensor) -> np.ndarray:
        """Decode revealed ring values to float64 on the host."""
        if tensor is None:
            return None
        if isinstance(tensor, torch.Tensor):
            t = tensor.detach().cpu().numpy().astype(np.int64)
        else:
            t = np.asarray(tensor).astype(np.uint64).view(np.int64)
        if self.scale > 1:
            return t.astype(np.float64) / float(self.scale)
        return nearest_integer_division(t, self.scale).astype(np.float64)

    def __repr__(self):
        return f"FixedPointEncoder(scale={self.scale})"
