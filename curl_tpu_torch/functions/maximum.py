"""max / max_value reductions (counterpart of ``curl_tpu/functions/maximum.py``).

This slice ports the methods the shipped config runs: ``log_reduction``
(pairwise halvings, then the all-pairs max of the remainder) and
``pairwise`` (all-pairs comparisons with a weighted random tie-break). The
fused TPU tournament step (``fused_max_step``) is off under the shipped
config and takes the composable path, as in the JAX package.
"""

from __future__ import annotations

import math

from ..config import cfg
from ..mpc.mpc import MPCTensor


def max(self, dim=None, keepdim=False, one_hot=True):
    method = cfg.functions.max_method
    if dim is None:
        raise NotImplementedError("max over all dims is not ported yet")
    argmax_result, max_result = _argmax_helper(self, dim=dim, method=method)
    if max_result is None:
        max_result = (self * argmax_result).sum(axis=dim, keepdim=keepdim)
    if keepdim and max_result.dim() < self.dim():
        max_result = max_result.unsqueeze(dim)
    if not one_hot:
        raise NotImplementedError("argmax indices are not ported yet")
    return max_result, argmax_result


def max_value(self, dim=None, keepdim=False):
    """Max VALUES only, without the argmax one-hot (maximum.py:65)."""
    method = cfg.functions.max_method
    if self.dim() == 0:
        return self
    if method != "log_reduction":
        raise NotImplementedError(f"max_method {method!r} is not ported yet")
    inp = self.flatten() if dim is None else self
    out = _max_helper_log_reduction(inp, dim=0 if dim is None else dim)
    if dim is not None and keepdim and out.dim() < self.dim():
        out = out.unsqueeze(dim)
    return out


def _argmax_helper_pairwise(enc_tensor, dim):
    """All-pairs comparisons, one round (maximum.py:95)."""
    row_length = enc_tensor.size(dim) if enc_tensor.size(dim) > 1 else 2
    a = enc_tensor.expand(row_length - 1, *enc_tensor.size())
    b = MPCTensor.stack([enc_tensor.roll(i + 1, dims=dim) for i in range(row_length - 1)])
    pairwise = a.ge(b)
    if row_length - 1 < 128:
        return pairwise.prod(0)
    return pairwise.sum(axis=0).ge(row_length - 1)


def _compute_pairwise_comparisons_for_steps(input_tensor, dim, steps):
    x = input_tensor
    for _ in range(steps):
        m = x.size(dim)
        a, b, remainder = x.split([m // 2, m // 2, m % 2], dim=dim)
        pairwise_max = a.where(a.ge(b), b)
        x = MPCTensor.cat([pairwise_max, remainder], axis=dim) if m % 2 else pairwise_max
    return x


def _max_helper_log_reduction(enc_tensor, dim):
    n = enc_tensor.size(dim)
    steps = int(math.log(n)) if n > 1 else 0
    reduced = _compute_pairwise_comparisons_for_steps(enc_tensor, dim, steps)
    with cfg.temp_override({"functions.max_method": "pairwise"}):
        enc_max_vec, _ = reduced.max(dim=dim)
    return enc_max_vec


def _argmax_helper(enc_tensor, dim, method):
    if method != "pairwise":
        raise NotImplementedError(f"argmax method {method!r} is not ported yet")
    result_args = _argmax_helper_pairwise(enc_tensor, dim)
    return result_args.weighted_index(dim), None


MPCTensor.max = max
MPCTensor.max_value = max_value
