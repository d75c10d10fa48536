"""Tensor type predicates (counterpart of ``curl_tpu/utils/tensor_types.py``;
the reference's curl/common/tensor_types.py): numpy arrays and torch
tensors are tensors, where the JAX package takes numpy and JAX arrays."""

from __future__ import annotations

import numpy as np
import torch


def is_tensor(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def is_float_tensor(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype.is_floating_point
    return is_tensor(x) and np.issubdtype(x.dtype, np.floating)


def is_int_tensor(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not x.dtype.is_floating_point and not x.dtype.is_complex and x.dtype != torch.bool
    return is_tensor(x) and np.issubdtype(x.dtype, np.integer)


def is_encrypted_tensor(x) -> bool:
    from ..mpc.mpc import MPCTensor

    return isinstance(x, MPCTensor)
