"""max / min / argmax / argmin reductions (counterpart of
``curl_tpu/functions/maximum.py``).

Every method of the JAX package: ``pairwise`` (all-pairs comparisons),
``log_reduction`` (pairwise halvings, then the all-pairs max of the
remainder), ``double_log_reduction`` (the max of sqrt(n) blocks of sqrt(n),
recursively), ``accelerated_cascade`` (log log n halvings, then the double
log reduction) and ``scan_reduction`` (a cascade of chunk folds and a
butterfly tail, each step one compare and a one-multiply select). A tree
method's argmax is its max,
then ``eq`` against it; ties are broken by a weighted random one-hot
(``weighted_index``) whatever the method. With ``mpc.fused_max_step`` =
"cuda" each stage of ``scan_reduction`` (a chunk fold's steps, the
butterfly's steps) is one fused pass (``kernels/max_step.py``), for the
softmax's max and the argmax alike.
"""

from __future__ import annotations

import builtins
import math

import numpy as np

from ..config import cfg
from ..mpc.mpc import MPCTensor

_TREES = ("log_reduction", "double_log_reduction", "accelerated_cascade", "scan_reduction")


def argmax(self, dim=None, keepdim=False, one_hot=True):
    """A private one-hot of the max along ``dim`` (of all elements where
    None), or its index with ``one_hot=False`` (maximum.py:24)."""
    method = cfg.functions.max_method
    if self.dim() == 0:
        return MPCTensor.encrypt(np.ones(()) if one_hot else np.zeros(()), src=0)
    result = _argmax_helper(self, dim, one_hot, method, _return_max=False)
    if not one_hot:
        result = _one_hot_to_index(result, dim, keepdim)
    return result


def argmin(self, dim=None, keepdim=False, one_hot=True):
    return (-self).argmax(dim=dim, keepdim=keepdim, one_hot=one_hot)


def max(self, dim=None, keepdim=False, one_hot=True):
    """The max along ``dim`` and its argmax (maximum.py:39); over all
    elements where ``dim`` is None (the max alone)."""
    method = cfg.functions.max_method
    if dim is None:
        if method in ("log_reduction", "double_log_reduction", "scan_reduction"):
            return _max_helper_all_tree_reductions(self, method=method)
        argmax_result = self.argmax(one_hot=True)
        return self.mul(argmax_result).sum()
    argmax_result, max_result = _argmax_helper(self, dim=dim, one_hot=True, method=method,
                                               _return_max=True)
    if max_result is None:
        max_result = (self * argmax_result).sum(axis=dim, keepdim=keepdim)
    if keepdim and max_result.dim() < self.dim():
        max_result = max_result.unsqueeze(dim)
    if one_hot:
        return max_result, argmax_result
    return max_result, _one_hot_to_index(argmax_result, dim, keepdim)


def min(self, dim=None, keepdim=False, one_hot=True):
    result = (-self).max(dim=dim, keepdim=keepdim, one_hot=one_hot)
    if dim is None:
        return -result
    return -result[0], result[1]


def max_value(self, dim=None, keepdim=False):
    """Max VALUES only, without the argmax one-hot (maximum.py:65)."""
    method = cfg.functions.max_method
    if self.dim() == 0:
        return self
    if method in _TREES:
        out = _max_helper_all_tree_reductions(self, dim=dim, method=method)
        if dim is not None and keepdim and out.dim() < self.dim():
            out = out.unsqueeze(dim)
        return out
    if dim is None:
        return self.max()
    return self.max(dim, keepdim=keepdim)[0]


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


def _max_helper_double_log_recursive(enc_tensor, dim):
    """The max along ``dim`` (kept) of sqrt(n) blocks' maxima
    (maximum.py:122-149): the first sqrt(n) * (n // sqrt(n)) lanes are
    reshaped into sqrt(n) rows along ``dim`` (the next dim takes the rest),
    reduced recursively, and the all-pairs max runs over their maxima and
    the remainder."""
    n = enc_tensor.size(dim)
    sqrt_n = int(math.sqrt(n))
    if n == 1:
        return enc_tensor
    if sqrt_n <= 1:
        with cfg.temp_override({"functions.max_method": "pairwise"}):
            return enc_tensor.max(dim=dim, keepdim=True)[0]
    count_sqrt_n = n // sqrt_n
    split_t, remainder = enc_tensor.split([sqrt_n * count_sqrt_n, n % sqrt_n], dim=dim)
    size_arr = list(enc_tensor.size())
    size_arr[dim], size_arr[dim + 1] = sqrt_n, enc_tensor.size(dim + 1) * count_sqrt_n
    split_max = _max_helper_double_log_recursive(split_t.reshape(size_arr), dim)
    size_arr[dim], size_arr[dim + 1] = count_sqrt_n, enc_tensor.size(dim + 1)
    full = split_max.reshape(size_arr)
    if n % sqrt_n:
        full = MPCTensor.cat([full, remainder], axis=dim)
    with cfg.temp_override({"functions.max_method": "pairwise"}):
        return full.max(dim=dim, keepdim=True)[0]


def _max_helper_double_log_reduction(enc_tensor, dim):
    """The max along ``dim`` by the double log reduction (maximum.py:152-167)."""
    dim = dim + enc_tensor.dim() if dim < 0 else dim
    size_arr = [enc_tensor.size(i) for i in range(enc_tensor.dim()) if i != dim]
    out = _max_helper_double_log_recursive(enc_tensor.unsqueeze(dim + 1), dim)
    return out.squeeze(dim + 1).reshape(size_arr)


def _max_helper_accelerated_cascade(enc_tensor, dim):
    """log log n pairwise halvings, then the double log reduction
    (maximum.py:170-186); the all-pairs max below 3 lanes."""
    n = enc_tensor.size(dim)
    if n < 3:
        with cfg.temp_override({"functions.max_method": "pairwise"}):
            return enc_tensor.max(dim=dim)[0]
    steps = int(math.log(builtins.max(math.log(builtins.max(math.log(n), 1)), 1))) + 1
    reduced = _compute_pairwise_comparisons_for_steps(enc_tensor, dim, steps)
    return _max_helper_double_log_reduction(reduced, dim)


def _scan_knob(name: str, default: int) -> int:
    """``cfg.functions.<name>``, or ``default`` where the profile lacks it
    (maximum.py:299-316)."""
    try:
        return int(getattr(cfg.functions, name))
    except (AttributeError, TypeError):
        return default


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

    fixed_width = 1 << int(math.floor(math.log2(builtins.max(
        _scan_knob("scan_fixed_width", 2048), 1))))
    cascade_factor = builtins.max(_scan_knob("scan_cascade_factor", 8), 2)
    cascade_min = 1 << int(math.floor(math.log2(builtins.max(
        _scan_knob("scan_cascade_min", 128), 1))))
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


def _max_helper_all_tree_reductions(enc_tensor, dim=None, method="log_reduction"):
    """The max along ``dim`` (of the flattened tensor where None) by a tree
    method (maximum.py:392)."""
    helpers = {"log_reduction": _max_helper_log_reduction,
               "double_log_reduction": _max_helper_double_log_reduction,
               "accelerated_cascade": _max_helper_accelerated_cascade,
               "scan_reduction": _max_helper_scan_reduction}
    if method not in helpers:
        raise RuntimeError("Unknown max method")
    if enc_tensor.dim() == 0:
        return enc_tensor
    if dim is None:
        enc_tensor, dim = enc_tensor.flatten(), 0
    return helpers[method](enc_tensor, dim)


def _argmax_helper_all_tree_reductions(enc_tensor, dim=None, method="log_reduction"):
    """(the lanes equal to the tree's max, the max) (maximum.py:404)."""
    enc_max_vec = _max_helper_all_tree_reductions(enc_tensor, dim=dim, method=method)
    enc_max_vec_orig = enc_max_vec.unsqueeze(dim) if dim is not None else enc_max_vec
    return enc_tensor.eq(enc_max_vec_orig), enc_max_vec


def _argmax_helper(enc_tensor, dim=None, one_hot=True, method="pairwise", _return_max=False):
    """The argmax one-hot along ``dim`` (maximum.py:411), ties broken by a
    weighted random one-hot; with ``_return_max`` also the max where the
    method makes it (None for pairwise)."""
    if enc_tensor.dim() == 0:
        result = MPCTensor.encrypt(np.ones(()) if one_hot else np.zeros(()), src=0)
        return (result, None) if _return_max else result
    updated = enc_tensor.flatten() if dim is None else enc_tensor
    if method == "pairwise":
        result_args = _argmax_helper_pairwise(updated, -1 if dim is None else dim)
        result_val = None
    elif method in _TREES:
        result_args, result_val = _argmax_helper_all_tree_reductions(updated, dim, method)
    else:
        raise RuntimeError("Unknown argmax method")
    result_args = result_args.weighted_index(dim)
    result_args = result_args.view(*enc_tensor.size()) if dim is None else result_args
    return (result_args, result_val) if _return_max else result_args


def _one_hot_to_index(tensor, dim, keepdim):
    """The index a one-hot marks: its lanes weighted by their indices,
    summed (maximum.py:431)."""
    if dim is None:
        flat = tensor.flatten()
        return flat.mul(np.arange(flat.size(0), dtype=np.float64)).sum()
    size = [1] * tensor.dim()
    size[dim] = tensor.size(dim)
    idx = np.arange(tensor.size(dim), dtype=np.float64).reshape(size)
    return tensor.mul(idx).sum(axis=dim, keepdim=keepdim)


for _name, _fn in (("argmax", argmax), ("argmin", argmin), ("max", max), ("min", min),
                   ("max_value", max_value)):
    setattr(MPCTensor, _name, _fn)
