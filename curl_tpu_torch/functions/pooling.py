"""Max and adaptive pooling over encrypted tensors (counterpart of
``curl_tpu/functions/pooling.py``).

``max_pool2d`` lays each window out along a trailing axis and runs the
configured private max over it (``scan_reduction`` under bench.py's
configuration, one fused max_step pass a stage), its argmax one-hot
included, as the JAX package does. The windows pad with a public constant
that no real value loses to: see ``_max_pad``, where this port departs from
the JAX package. The gradient (``_max_pool2d_backward``) belongs with
training (ROADMAP A13).
"""

from __future__ import annotations

import torch

from ..mpc.mpc import MPCTensor, _compare_bits


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pooling_output_shape(input_size, kernel_size, pad_l, pad_r, stride, dilation, ceil_mode):
    numerator = input_size + pad_l + pad_r - dilation * (kernel_size - 1) - 1
    if ceil_mode:
        numerator += stride - 1
    output_size = numerator // stride + 1
    if ceil_mode and (output_size - 1) * stride >= input_size + pad_l:
        output_size -= 1
    return output_size


def _pool2d_reshape(self, kernel_size, padding=None, stride=None, dilation=1,
                    ceil_mode=False, pad_value=0):
    """(windows, output size): the last two dims' windows as a trailing axis
    of k0 * k1 (pooling.py:33-67), read from ``Tensor.unfold`` views of the
    padded shares and copied once."""
    k = _pair(kernel_size)
    s = k if stride is None else _pair(stride)
    d = _pair(dilation)
    padding = (0, 0) if padding is None else _pair(padding)
    n = tuple(self.shape[:-2])
    h = _pooling_output_shape(self.shape[-2], k[0], padding[0], padding[0], s[0], d[0], ceil_mode)
    w = _pooling_output_shape(self.shape[-1], k[1], padding[1], padding[1], s[1], d[1], ceil_mode)
    x = self.pad((padding[1], padding[1], padding[0], padding[0]), value=pad_value)
    if ceil_mode:
        extra_h = h * s[0] + (k[0] - 1) * d[0] - x.shape[-2]
        extra_w = w * s[1] + (k[1] - 1) * d[1] - x.shape[-1]
        x = x.pad((0, max(extra_w, 0), 0, max(extra_h, 0)), value=pad_value)
    share = x.share
    nd = share.dim()
    win = share.unfold(nd - 2, d[0] * (k[0] - 1) + 1, s[0]).unfold(nd - 1, d[1] * (k[1] - 1) + 1,
                                                                   s[1])
    win = win[..., :h, :w, ::d[0], ::d[1]]  # (P, *n, h, w, k0, k1)
    windows = win.reshape(win.shape[:-2] + (k[0] * k[1],))
    return MPCTensor(type(x._tensor)(windows, self.encoder), self.ptype), n + (h, w)


def _max_pad(encoder) -> float:
    """The pad of ``max_pool2d``'s windows. The JAX package pads with
    -2^24 (pooling.py:76), which a packed compare of w = mpc.compare_bits <
    64 bits reads mod 2^w: at the default 32 bits and 16 fractional bits its
    encoding -2^40 is 0 there, and it wins every window whose real entries
    are at most 0 (ROADMAP Queue C). The port pads with -2^(w-2) ring units
    instead (-2^(w-2-precision) decoded, -16384 at 32 bits): below every
    real value in (-2^(w-2), 2^(w-2)) ring units, and within 2^(w-1) of each
    of them, so the compare orders the pad right over that whole range,
    which holds the packed compare's own range of ordered values
    (differences below 2^(w-1)). At w = 64 it keeps -2^24. Only the
    constant differs: the rounds and bytes are the JAX package's."""
    width = _compare_bits()
    if width >= 64:
        return -float(2 ** 24)
    return -float(2 ** (width - 2 - encoder.precision_bits))


def max_pool2d(self, kernel_size, padding=0, stride=None, dilation=1,
               ceil_mode=False, return_indices=False):
    """Each window's private max (and its argmax one-hot, (..., h, w, k0,
    k1), with ``return_indices``) (pooling.py:70-82)."""
    windows, output_size = _pool2d_reshape(
        self, kernel_size, padding=padding, stride=stride, dilation=dilation,
        ceil_mode=ceil_mode, pad_value=_max_pad(self.encoder),
    )
    max_vals, argmax_vals = windows.max(dim=-1, one_hot=True)
    max_vals = max_vals.view(output_size)
    if return_indices:
        return max_vals, argmax_vals.view(output_size + _pair(kernel_size))
    return max_vals


def _window_positions(h, w, k, s, d, width, device):
    """(h * w * k0 * k1,) int64 on ``device``: each window entry's flat
    position in a (rows, ``width``) plane, windows in (i, j) order, entries
    in (a, b) order."""
    def ar(n, step):
        return torch.arange(n, device=device) * step

    rows = ar(h, s[0]).view(h, 1, 1, 1) + ar(k[0], d[0]).view(1, 1, -1, 1)
    cols = ar(w, s[1]).view(1, w, 1, 1) + ar(k[1], d[1]).view(1, 1, 1, -1)
    return (rows * width + cols).reshape(-1)


def _max_pool2d_backward(self, indices, kernel_size, padding=None, stride=None,
                         dilation=1, ceil_mode=False, output_size=None):
    """The gradient ``self`` (N, C, h, w) of a max pool scattered through
    its argmax one-hots ``indices`` (N, C, h, w, k0, k1) into the input's
    positions (pooling.py:85-136): one private product by the one-hots,
    then every window's entries added at their positions, windows that
    overlap summed, in one indexed add of the shares (where the JAX
    package adds window by window); the padding cut off."""
    k = _pair(kernel_size)
    p = (0, 0) if padding is None else _pair(padding)
    s = k if stride is None else _pair(stride)
    d = _pair(dilation)

    assert self.dim() == 4, "Input to _max_pool2d_backward must have 4 dimensions"
    assert indices.dim() == 6, "Indices input must have 6 dimensions"

    kernels = self.view(tuple(self.size()) + (1, 1)) * indices

    if output_size is None:
        output_size = (self.size(0), self.size(1), s[0] * self.size(2) - 2 * p[0],
                       s[1] * self.size(3) - 2 * p[1])
    result_size = list(output_size)
    result_size[-2] += 2 * p[0]
    result_size[-1] += 2 * p[1]
    if ceil_mode:
        c0 = self.size(-1) * s[1] + (k[1] - 1) * d[1] - output_size[-1]
        c1 = self.size(-2) * s[0] + (k[0] - 1) * d[0] - output_size[-2]
        result_size[-2] += c0
        result_size[-1] += c1

    h, w = self.size(2), self.size(3)
    kshare = kernels.share
    P = kshare.shape[0]
    lead = tuple(kshare.shape[1:3])
    index = _window_positions(h, w, k, s, d, result_size[-1], kshare.device)
    share = torch.zeros((P,) + lead + (result_size[-2] * result_size[-1],), dtype=kshare.dtype,
                        device=kshare.device)
    share.index_add_(3, index, kshare.reshape((P,) + lead + (-1,)))
    share = share.view((P,) + lead + tuple(result_size[-2:]))

    if ceil_mode:
        share = share[..., : share.shape[-2] - c0, : share.shape[-1] - c1]
    share = share[..., p[0]: share.shape[-2] - p[0], p[1]: share.shape[-1] - p[1]]
    return MPCTensor(type(kernels._tensor)(share, kernels.encoder), self.ptype)


def adaptive_avg_pool2d(self, output_size):
    """torch's adaptive average pooling, where its windows are uniform
    (pooling.py:146-153)."""
    if output_size is None or output_size[0] is None:
        output_size = self.shape[-2:]
    if tuple(self.shape[-2:]) == tuple(output_size):
        return self.clone()
    resized, args, kwargs = _adaptive_pool2d_helper(self, output_size, reduction="mean")
    return resized.avg_pool2d(*args, **kwargs)


def adaptive_max_pool2d(self, output_size, return_indices=False):
    """torch's adaptive max pooling (pooling.py:156-166)."""
    import numpy as np

    if output_size is None or output_size[0] is None:
        output_size = self.shape[-2:]
    if tuple(self.shape[-2:]) == tuple(output_size):
        if return_indices:
            return self.clone(), MPCTensor.encrypt(np.ones(tuple(self.size()) + tuple(output_size)))
        return self.clone()
    resized, args, kwargs = _adaptive_pool2d_helper(self, output_size, reduction="max")
    return resized.max_pool2d(*args, **kwargs, return_indices=return_indices)


def _adaptive_pool2d_helper(inp, output_size, reduction="mean"):
    """The input with boundary rows and columns repeated so that one
    uniform window and stride give torch's adaptive cells
    (pooling.py:169-210); (resized, args, kwargs) of that pooling."""
    output_size = list(_pair(output_size))
    for i in range(2):
        if output_size[i] is None:
            output_size[i] = inp.shape[-2 + i]
    x, ks = inp, []
    for axis, size_in, size_out in ((-2, inp.shape[-2], output_size[0]),
                                    (-1, inp.shape[-1], output_size[1])):
        starts = [(i * size_in) // size_out for i in range(size_out)]
        ends = [-(-((i + 1) * size_in) // size_out) for i in range(size_out)]
        sizes = [e - s for s, e in zip(starts, ends)]
        if reduction == "mean" and len(set(sizes)) > 1:
            raise NotImplementedError("adaptive_avg_pool2d with non-uniform kernels is not supported")
        k = max(sizes)
        idx = []
        for s, e in zip(starts, ends):
            cell = list(range(s, e))
            cell += [cell[-1]] * (k - len(cell))  # repeat the last row
            idx.extend(cell)
        x = x.index_select(axis, idx)
        ks.append(k)
    return x, ((ks[0], ks[1]),), {"stride": (ks[0], ks[1])}


for _name, _fn in (
    ("max_pool2d", max_pool2d),
    ("_max_pool2d_backward", _max_pool2d_backward),
    ("adaptive_avg_pool2d", adaptive_avg_pool2d),
    ("adaptive_max_pool2d", adaptive_max_pool2d),
):
    setattr(MPCTensor, _name, _fn)
