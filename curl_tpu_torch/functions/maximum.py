"""max / max_value reductions (counterpart of ``curl_tpu/functions/maximum.py``).

Ported methods: ``log_reduction`` (pairwise halvings, then the all-pairs max
of the remainder), ``pairwise`` (all-pairs comparisons with a weighted
random tie-break) and ``scan_reduction`` (a cascade of chunk folds and a
butterfly tail, each step one compare and a one-multiply select). With
``mpc.fused_max_step`` = "cuda" each stage of ``scan_reduction`` (a chunk
fold's steps, the butterfly's steps) is one fused pass
(``kernels/max_step.py``).
"""

from __future__ import annotations

import builtins
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
    helpers = {"log_reduction": _max_helper_log_reduction,
               "scan_reduction": _max_helper_scan_reduction}
    if method not in helpers:
        raise NotImplementedError(f"max_method {method!r} is not ported yet")
    inp = self.flatten() if dim is None else self
    out = helpers[method](inp, dim=0 if dim is None else dim)
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


def _use_fused_max_step() -> bool:
    """cfg.mpc.fused_max_step = "cuda": each tournament step (compare +
    select) as one fused pass (``kernels/max_step.py``); 2 parties only."""
    from .. import comm

    return getattr(cfg.mpc, "fused_max_step", None) == "cuda" and comm.get_world_size() == 2


def _tournament_select(carry, rolled, fused):
    """new = rolled + (carry >= rolled) * (carry - rolled): one compare and a
    one-multiply select, or one fused pass."""
    if fused:
        from ..kernels import max_step

        return max_step.fused_max_step_mpc(carry, rolled)
    keep = carry.ge(rolled)
    return carry.sub(rolled).mul(keep).add(rolled)


def _max_helper_scan_reduction(enc_tensor, dim):
    """Max along ``dim`` by a cascade of chunk folds and a butterfly tail
    (maximum.py:235-389).

    The reduce axis moves last and pads to a power of two with the public
    sentinel -2^(w-3-precision) (w = mpc.compare_bits: the most negative
    value whose differences stay inside the comparison ring). Then the axis
    folds as (G, W) chunks into a running elementwise max (W =
    functions.scan_fixed_width), shrinks by functions.scan_cascade_factor a
    stage down to functions.scan_cascade_min, and a butterfly of rolls
    leaves the max in lane 0. The JAX package runs each stage as one
    ``lax.scan`` body and forks the protocol randomness per step
    (``rng.fork``); here each stage is a Python loop, or one fused pass of
    all its steps (``fused_fold_chain_mpc``, ``fused_butterfly_chain_mpc``),
    and every step's draws come from a fresh draw count, so no fork is
    needed.
    """
    from ..mpc.mpc import _compare_bits

    dim = dim + enc_tensor.dim() if dim < 0 else dim
    x = enc_tensor
    if dim != x.dim() - 1:
        x = x.permute(*[i for i in range(x.dim()) if i != dim], dim)
    n = x.size(x.dim() - 1)
    padded = 1 << (math.ceil(math.log2(n)) if n > 1 else 1)
    if padded != n:
        prec = enc_tensor.encoder.precision_bits
        x = x.pad((0, padded - n), value=-float(2 ** (_compare_bits() - 3 - prec)))

    F = cfg.functions
    fixed_width = 1 << int(math.floor(math.log2(builtins.max(int(F.scan_fixed_width), 1))))
    cascade_factor = builtins.max(int(F.scan_cascade_factor), 2)
    cascade_min = 1 << int(math.floor(math.log2(builtins.max(int(F.scan_cascade_min), 1))))
    fused = _use_fused_max_step()

    def fold_to(x, width_out):
        """(..., W_in) -> (..., width_out): a running max over the chunks."""
        groups = x.size(x.dim() - 1) // width_out
        chunked = x.reshape(*(tuple(x.size()[:-1]) + (groups, width_out)))
        if fused and groups > 1:
            from ..kernels import max_step

            return max_step.fused_fold_chain_mpc(chunked)
        d = chunked.dim()
        carry = chunked.narrow(d - 2, 0, 1).squeeze(d - 2)
        for g in range(1, groups):
            carry = _tournament_select(carry, chunked.narrow(d - 2, g, 1).squeeze(d - 2), fused)
        return carry

    width = builtins.min(padded, fixed_width)
    if padded > width:
        x = fold_to(x, width)
    while width > cascade_min:
        width_next = builtins.max(width // cascade_factor, cascade_min)
        x = fold_to(x, width_next)
        width = width_next
    # butterfly tail: the max lands in lane 0
    k_tail = math.ceil(math.log2(width)) if width > 1 else 0
    if fused and k_tail:
        from ..kernels import max_step

        x = max_step.fused_butterfly_chain_mpc(x, k_tail)
    else:
        for i in range(k_tail):
            x = _tournament_select(x, x.roll(-(width >> (i + 1)), dims=x.dim() - 1), fused)
    return x.narrow(x.dim() - 1, 0, 1).squeeze(x.dim() - 1)


def _argmax_helper(enc_tensor, dim, method):
    if method != "pairwise":
        raise NotImplementedError(f"argmax method {method!r} is not ported yet")
    result_args = _argmax_helper_pairwise(enc_tensor, dim)
    return result_args.weighted_index(dim), None


MPCTensor.max = max
MPCTensor.max_value = max_value
