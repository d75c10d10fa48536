"""Backward formulas for encrypted ops (counterpart of
``curl_tpu/gradients.py``; the reference's curl/gradients.py:158-2161).

Every backward is itself an MPC program, the JAX package's formula op for
op, so a step's rounds and bytes are curl_tpu's. ``install`` wraps the
registered names onto ``MPCTensor`` (``autograd.install_autograd``); the
forward ops that exist only here (relu6, cosine_similarity, the losses,
batchnorm, layernorm, attention, ...) become methods first, each its
function's forward.

Public operands are numpy float64 arrays, made on the host and copied to
the device once (``ring.host_constant``), so that a backward captured in a
CUDA graph copies nothing from the host. Where the JAX package's formula
is wrong, the port says so beside it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .autograd import FUNCTION_REGISTRY, AutogradContext, AutogradFunction, register_function


def _shape_of(x):
    if hasattr(x, "shape"):
        return tuple(x.shape)
    return tuple(np.shape(x))


def _reduce_broadcast(grad, shape):
    """Sum-reduce grad to the given (broadcast-source) shape."""
    gshape = _shape_of(grad)
    if gshape == tuple(shape):
        return grad
    while len(_shape_of(grad)) > len(shape):
        grad = grad.sum(axis=0)
    for i, (gs, s) in enumerate(zip(_shape_of(grad), shape)):
        if s == 1 and gs != 1:
            grad = grad.sum(axis=i, keepdim=True)
    return grad


def _is_enc(x):
    return hasattr(type(x), "share")


def _public(x):
    """A public operand as the formulas use it: a torch tensor as it is,
    anything else as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x
    return np.asarray(x, dtype=np.float64)


def _swap_last(x):
    """A public matrix operand with its last two axes swapped."""
    if isinstance(x, torch.Tensor):
        return x.transpose(-2, -1)
    return np.swapaxes(np.asarray(x), -2, -1)


# -- arithmetic --------------------------------------------------------------

@register_function("add")
class AutogradAdd(AutogradFunction):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_multiple_for_backward([_shape_of(a), _shape_of(b), _is_enc(b)])
        return a.add(b)

    @staticmethod
    def backward(ctx, grad):
        sa, sb, b_enc = ctx.saved_tensors
        ga = _reduce_broadcast(grad, sa)
        gb = _reduce_broadcast(grad, sb) if b_enc else None
        return (ga, gb)


@register_function("sub")
class AutogradSub(AutogradFunction):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_multiple_for_backward([_shape_of(a), _shape_of(b), _is_enc(b)])
        return a.sub(b)

    @staticmethod
    def backward(ctx, grad):
        sa, sb, b_enc = ctx.saved_tensors
        ga = _reduce_broadcast(grad, sa)
        gb = _reduce_broadcast(grad.neg(), sb) if b_enc else None
        return (ga, gb)


@register_function("neg")
class AutogradNeg(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        return a.neg()

    @staticmethod
    def backward(ctx, grad):
        return grad.neg()


@register_function("mul")
class AutogradMul(AutogradFunction):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_multiple_for_backward([a, b, _is_enc(b)])
        return a.mul(b)

    @staticmethod
    def backward(ctx, grad):
        a, b, b_enc = ctx.saved_tensors
        ga = _reduce_broadcast(grad.mul(b), _shape_of(a))
        gb = _reduce_broadcast(grad.mul(a), _shape_of(b)) if b_enc else None
        return (ga, gb)


@register_function("div")
class AutogradDiv(AutogradFunction):
    @staticmethod
    def forward(ctx, a, b):
        if _is_enc(b):
            raise NotImplementedError("gradient through private divisor")
        ctx.save_for_backward(b)
        return a.div(b)

    @staticmethod
    def backward(ctx, grad):
        b = ctx.saved_tensors[0]
        return (grad.div(b), None)


@register_function("square")
class AutogradSquare(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return a.square()

    @staticmethod
    def backward(ctx, grad):
        (a,) = ctx.saved_tensors
        return grad.mul(a).mul(2)


@register_function("matmul")
class AutogradMatmul(AutogradFunction):
    """The JAX package transposes a public right operand with
    ``b.transpose(-2, -1)``, which on a jax array is the permutation
    (-2, -1), the identity of a matrix: its input gradient is grad @ b, not
    grad @ b^T (ROADMAP Queue C). The port swaps the axes (the same public
    product, so the same rounds and bytes)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_multiple_for_backward([a, b, _is_enc(b)])
        return a.matmul(b)

    @staticmethod
    def backward(ctx, grad):
        a, b, b_enc = ctx.saved_tensors
        bt = b.transpose(-2, -1) if b_enc else _swap_last(b)
        at = a.transpose(-2, -1)
        ga = _reduce_broadcast(grad.matmul(bt), _shape_of(a))
        gb = None
        if b_enc:
            gb = _reduce_broadcast(at.matmul(grad), _shape_of(b))
        return (ga, gb)


@register_function("dot")
class AutogradDot(AutogradFunction):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_multiple_for_backward([a, b, _is_enc(b)])
        return a.dot(b)

    @staticmethod
    def backward(ctx, grad):
        a, b, b_enc = ctx.saved_tensors
        ga = grad.mul(b)
        gb = grad.mul(a) if b_enc else None
        return (ga, gb)


@register_function("pow")
class AutogradPow(AutogradFunction):
    @staticmethod
    def forward(ctx, a, p):
        ctx.save_multiple_for_backward([a, p])
        return a.pow(p)

    @staticmethod
    def backward(ctx, grad):
        a, p = ctx.saved_tensors
        return grad.mul(a.pow(p - 1)).mul(p)


# -- transcendental ----------------------------------------------------------

@register_function("exp")
class AutogradExp(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        out = a.exp()
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        return grad.mul(out)


@register_function("log")
class AutogradLog(AutogradFunction):
    @staticmethod
    def forward(ctx, a, **kwargs):
        ctx.save_for_backward(a)
        return a.log(**kwargs)

    @staticmethod
    def backward(ctx, grad):
        (a,) = ctx.saved_tensors
        return grad.mul(a.reciprocal())


@register_function("reciprocal")
class AutogradReciprocal(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        out = a.reciprocal()
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        return grad.mul(out.square()).neg()


@register_function("sqrt")
class AutogradSqrt(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        out = a.sqrt()
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        return grad.mul(out.reciprocal()).div(2)


@register_function("sigmoid")
class AutogradSigmoid(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        out = a.sigmoid()
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        return grad.mul(out).mul(out.neg().add(1))


@register_function("tanh")
class AutogradTanh(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        out = a.tanh()
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        return grad.mul(out.square().neg().add(1))


@register_function("erf")
class AutogradErf(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return a.erf()

    @staticmethod
    def backward(ctx, grad):
        (a,) = ctx.saved_tensors
        scale = 2.0 / math.sqrt(math.pi)
        return grad.mul(a.square().neg().exp()).mul(scale)


@register_function("gelu")
class AutogradGelu(AutogradFunction):
    """d gelu(x) = Phi(x) + x phi(x) (reference gradients.py:631)."""

    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return a.gelu()

    @staticmethod
    def backward(ctx, grad):
        (a,) = ctx.saved_tensors
        invsqrt2 = 1.0 / math.sqrt(2)
        phi_cdf = a.mul(invsqrt2).erf().add(1).div(2)
        pdf = a.square().div(2).neg().exp().mul(1.0 / math.sqrt(2 * math.pi))
        return grad.mul(phi_cdf.add(a.mul(pdf)))


@register_function("silu")
class AutogradSilu(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        sig = a.sigmoid()
        ctx.save_multiple_for_backward([a, sig])
        return a.mul(sig)

    @staticmethod
    def backward(ctx, grad):
        a, sig = ctx.saved_tensors
        one_minus = sig.neg().add(1)
        return grad.mul(sig.mul(a.mul(one_minus).add(1)))


@register_function("relu")
class AutogradReLU(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        mask = a.gt(0)
        ctx.save_for_backward(mask)
        return a.mul(mask)

    @staticmethod
    def backward(ctx, grad):
        (mask,) = ctx.saved_tensors
        return grad.mul(mask)


@register_function("hardtanh")
class AutogradHardtanh(AutogradFunction):
    @staticmethod
    def forward(ctx, a, min_value=-1, max_value=1):
        stacked = _module_stack([a.sub(min_value), a.sub(max_value)], 0)
        mask_stack = stacked.gt(0)
        inter = stacked.relu()
        ctx.save_for_backward(mask_stack)
        return inter[0].sub(inter[1]).add(min_value)

    @staticmethod
    def backward(ctx, grad):
        (masks,) = ctx.saved_tensors
        grad_mask = masks[0].sub(masks[1])
        return grad.mul(grad_mask)


@register_function("abs")
class AutogradAbs(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        sgn = a.sign()
        ctx.save_for_backward(sgn)
        return a.mul(sgn)

    @staticmethod
    def backward(ctx, grad):
        (sgn,) = ctx.saved_tensors
        return grad.mul(sgn)


@register_function("dropout")
class AutogradDropout(AutogradFunction):
    @staticmethod
    def forward(ctx, a, p=0.5, training=True, inplace=False):
        if not training or p == 0.0:
            ctx.save_for_backward(None)
            return a.clone()
        mask = type(a).rand(*a.size()).gt(p)
        ctx.save_multiple_for_backward([mask, p])
        return a.mul(mask).div(1 - p)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        if saved[0] is None:
            return grad
        mask, p = saved
        return grad.mul(mask).div(1 - p)


# -- structure ---------------------------------------------------------------

@register_function("view")
class AutogradView(AutogradFunction):
    @staticmethod
    def forward(ctx, a, *shape):
        ctx.save_for_backward(_shape_of(a))
        return a.view(*shape)

    @staticmethod
    def backward(ctx, grad):
        (shape,) = ctx.saved_tensors
        return grad.view(*shape)


@register_function("reshape")
class AutogradReshape(AutogradFunction):
    @staticmethod
    def forward(ctx, a, *shape):
        ctx.save_for_backward(_shape_of(a))
        return a.reshape(*shape)

    @staticmethod
    def backward(ctx, grad):
        (shape,) = ctx.saved_tensors
        return grad.reshape(*shape)


@register_function("flatten")
class AutogradFlatten(AutogradFunction):
    @staticmethod
    def forward(ctx, a, start_dim=0, end_dim=-1):
        ctx.save_for_backward(_shape_of(a))
        return a.flatten(start_dim, end_dim)

    @staticmethod
    def backward(ctx, grad):
        (shape,) = ctx.saved_tensors
        return grad.view(*shape)


@register_function("squeeze")
class AutogradSqueeze(AutogradFunction):
    @staticmethod
    def forward(ctx, a, axis=None):
        ctx.save_for_backward(_shape_of(a))
        return a.squeeze(axis)

    @staticmethod
    def backward(ctx, grad):
        (shape,) = ctx.saved_tensors
        return grad.view(*shape)


@register_function("unsqueeze")
class AutogradUnsqueeze(AutogradFunction):
    @staticmethod
    def forward(ctx, a, axis):
        ctx.save_for_backward(axis)
        return a.unsqueeze(axis)

    @staticmethod
    def backward(ctx, grad):
        (axis,) = ctx.saved_tensors
        return grad.squeeze(axis)


@register_function("t")
class AutogradT(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        return a.t()

    @staticmethod
    def backward(ctx, grad):
        return grad.t()


@register_function("transpose")
class AutogradTranspose(AutogradFunction):
    @staticmethod
    def forward(ctx, a, d0, d1):
        ctx.save_multiple_for_backward([d0, d1])
        return a.transpose(d0, d1)

    @staticmethod
    def backward(ctx, grad):
        d0, d1 = ctx.saved_tensors
        return grad.transpose(d0, d1)


@register_function("permute")
class AutogradPermute(AutogradFunction):
    @staticmethod
    def forward(ctx, a, *dims):
        if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
            dims = tuple(dims[0])
        ctx.save_for_backward(dims)
        return a.permute(*dims)

    @staticmethod
    def backward(ctx, grad):
        (dims,) = ctx.saved_tensors
        inverse = [0] * len(dims)
        for i, d in enumerate(dims):
            inverse[d] = i
        return grad.permute(*inverse)


@register_function("roll")
class AutogradRoll(AutogradFunction):
    @staticmethod
    def forward(ctx, a, shifts, dims=None):
        ctx.save_multiple_for_backward([shifts, dims])
        return a.roll(shifts, dims=dims)

    @staticmethod
    def backward(ctx, grad):
        shifts, dims = ctx.saved_tensors
        if isinstance(shifts, (list, tuple)):
            shifts = [-s for s in shifts]
        else:
            shifts = -shifts
        return grad.roll(shifts, dims=dims)


@register_function("narrow")
class AutogradNarrow(AutogradFunction):
    @staticmethod
    def forward(ctx, a, dim, start, length):
        ctx.save_multiple_for_backward([_shape_of(a), dim, start, length])
        return a.narrow(dim, start, length)

    @staticmethod
    def backward(ctx, grad):
        shape, dim, start, length = ctx.saved_tensors
        dim = dim % len(shape)
        # pad's pairs run from the last dim to ``dim``
        pads_tail = []
        for i in range(len(shape) - 1, dim - 1, -1):
            if i == dim:
                pads_tail.extend([start, shape[i] - start - length])
            else:
                pads_tail.extend([0, 0])
        return grad.pad(tuple(pads_tail), value=0)


@register_function("index_select")
class AutogradIndexSelect(AutogradFunction):
    @staticmethod
    def forward(ctx, a, dim, index):
        ctx.save_multiple_for_backward([_shape_of(a), dim, index])
        return a.index_select(dim, index)

    @staticmethod
    def backward(ctx, grad):
        shape, dim, index = ctx.saved_tensors
        out = _zeros_like_with(grad, shape)
        return out.index_add(dim, index, grad)


@register_function("gather")
class AutogradGather(AutogradFunction):
    @staticmethod
    def forward(ctx, a, dim, index):
        ctx.save_multiple_for_backward([_shape_of(a), dim, index])
        return a.gather(dim, index)

    @staticmethod
    def backward(ctx, grad):
        shape, dim, index = ctx.saved_tensors
        out = _zeros_like_with(grad, shape)
        return out.scatter_add(dim, index, grad)


def _zeros_like_with(grad, shape):
    """Encrypted zeros of ``shape``, made on the session's device."""
    from . import comm
    from .mpc.mpc import MPCTensor

    return MPCTensor.encrypt(torch.zeros(shape, dtype=torch.float64, device=comm.get_device()))


@register_function("cumsum")
class AutogradCumsum(AutogradFunction):
    @staticmethod
    def forward(ctx, a, dim):
        ctx.save_for_backward(dim)
        return a.cumsum(dim)

    @staticmethod
    def backward(ctx, grad):
        (dim,) = ctx.saved_tensors
        return grad.flip(dim).cumsum(dim).flip(dim)


@register_function("pad")
class AutogradPad(AutogradFunction):
    @staticmethod
    def forward(ctx, a, pad_width, value=0):
        ctx.save_multiple_for_backward([_shape_of(a), tuple(pad_width)])
        return a.pad(pad_width, value=value)

    @staticmethod
    def backward(ctx, grad):
        shape, pad_width = ctx.saved_tensors
        nd = len(shape)
        idx = [slice(None)] * nd
        for i in range(len(pad_width) // 2):
            dim = nd - 1 - i
            lo = pad_width[2 * i]
            idx[dim] = slice(lo, lo + shape[dim])
        return grad[tuple(idx)]


# -- reductions --------------------------------------------------------------

@register_function("sum")
class AutogradSum(AutogradFunction):
    @staticmethod
    def forward(ctx, a, axis=None, keepdim=False):
        ctx.save_multiple_for_backward([_shape_of(a), axis, keepdim])
        return a.sum(axis=axis, keepdim=keepdim)

    @staticmethod
    def backward(ctx, grad):
        shape, axis, keepdim = ctx.saved_tensors
        if axis is not None and not keepdim:
            grad = grad.unsqueeze(axis)
        return grad.mul(np.ones(shape))


@register_function("mean")
class AutogradMean(AutogradFunction):
    @staticmethod
    def forward(ctx, a, axis=None, keepdim=False):
        ctx.save_multiple_for_backward([_shape_of(a), axis, keepdim])
        return a.mean(axis=axis, keepdim=keepdim)

    @staticmethod
    def backward(ctx, grad):
        shape, axis, keepdim = ctx.saved_tensors
        if axis is None:
            n = int(np.prod(shape))
        elif isinstance(axis, (tuple, list)):
            n = int(np.prod([shape[a] for a in axis]))
        else:
            n = shape[axis]
        if axis is not None and not keepdim:
            grad = grad.unsqueeze(axis)
        return grad.mul(np.ones(shape) / n)


@register_function("var")
class AutogradVar(AutogradFunction):
    @staticmethod
    def forward(ctx, a, axis=None, keepdim=False, unbiased=False):
        m = a.mean(axis=axis, keepdim=True) if axis is not None else a.mean()
        diff = a.sub(m)
        if axis is None:
            n = int(np.prod(_shape_of(a)))
        elif isinstance(axis, (tuple, list)):
            n = int(np.prod([_shape_of(a)[ax] for ax in axis]))
        else:
            n = _shape_of(a)[axis]
        if unbiased:
            n = n - 1
        ctx.save_multiple_for_backward([diff, n, axis, keepdim])
        return diff.square().sum(axis=axis, keepdim=keepdim).div(n)

    @staticmethod
    def backward(ctx, grad):
        diff, n, axis, keepdim = ctx.saved_tensors
        if axis is not None and not keepdim:
            grad = grad.unsqueeze(axis)
        return diff.mul(grad).mul(2.0 / n)


@register_function("min")
class AutogradMin(AutogradFunction):
    @staticmethod
    def forward(ctx, a, dim=None, keepdim=False, one_hot=True):
        result = a.min(dim=dim, keepdim=keepdim, one_hot=True)
        if dim is None:
            argmin = a.argmin(one_hot=True)
            ctx.save_multiple_for_backward([argmin, dim, keepdim])
            ctx.mark_non_differentiable(argmin)
            return result
        minval, argmin = result
        ctx.save_multiple_for_backward([argmin, dim, keepdim])
        ctx.mark_non_differentiable(argmin)
        return minval, argmin

    @staticmethod
    def backward(ctx, grad):
        argmin, dim, keepdim = ctx.saved_tensors
        if dim is not None and not keepdim:
            grad = grad.unsqueeze(dim)
        return argmin.mul(grad)


@register_function("max")
class AutogradMax(AutogradFunction):
    @staticmethod
    def forward(ctx, a, dim=None, keepdim=False, one_hot=True):
        result = a.max(dim=dim, keepdim=keepdim, one_hot=True)
        if dim is None:
            argmax = a.argmax(one_hot=True)
            ctx.save_multiple_for_backward([argmax, dim, keepdim])
            ctx.mark_non_differentiable(argmax)
            return result
        maxval, argmax = result
        ctx.save_multiple_for_backward([argmax, dim, keepdim])
        ctx.mark_non_differentiable(argmax)
        return maxval, argmax

    @staticmethod
    def backward(ctx, grad):
        argmax, dim, keepdim = ctx.saved_tensors
        if dim is not None and not keepdim:
            grad = grad.unsqueeze(dim)
        return argmax.mul(grad)


# -- softmax family ----------------------------------------------------------

@register_function("softmax")
class AutogradSoftmax(AutogradFunction):
    @staticmethod
    def forward(ctx, a, dim=-1, **kwargs):
        out = a.softmax(dim)
        ctx.save_multiple_for_backward([out, dim])
        return out

    @staticmethod
    def backward(ctx, grad):
        out, dim = ctx.saved_tensors
        gp = out.mul(grad)
        return gp.sub(out.mul(gp.sum(axis=dim, keepdim=True)))


@register_function("log_softmax")
class AutogradLogSoftmax(AutogradFunction):
    @staticmethod
    def forward(ctx, a, dim=-1, **kwargs):
        out = a.log_softmax(dim)
        ctx.save_multiple_for_backward([out, dim])
        return out

    @staticmethod
    def backward(ctx, grad):
        out, dim = ctx.saved_tensors
        with_exp = out.exp()
        return grad.sub(with_exp.mul(grad.sum(axis=dim, keepdim=True)))


# -- conv / pool -------------------------------------------------------------

@register_function("conv2d")
class AutogradConv2d(AutogradFunction):
    """The input gradient is the transposed convolution of the output
    gradient by the same kernel; the kernel's, the input correlated with
    the output gradient, batch and channel axes swapped (gradients.py:
    752-789). Grouped convolutions raise."""

    @staticmethod
    def forward(ctx, a, kernel, stride=1, padding=0, dilation=1, groups=1):
        ctx.save_multiple_for_backward(
            [a, kernel, _is_enc(kernel), stride, padding, dilation, groups]
        )
        return a.conv2d(kernel, stride=stride, padding=padding,
                        dilation=dilation, groups=groups)

    @staticmethod
    def backward(ctx, grad):
        a, kernel, k_enc, stride, padding, dilation, groups = ctx.saved_tensors
        if groups != 1:
            raise NotImplementedError("grouped conv backward")
        kshape = _shape_of(kernel)
        ga = grad.conv_transpose2d(
            kernel, stride=stride, padding=padding, dilation=dilation
        )
        ashape = _shape_of(a)
        if _shape_of(ga)[-2:] != tuple(ashape[-2:]):
            ga = ga.narrow(-2, 0, ashape[-2]).narrow(-1, 0, ashape[-1])
        gk = None
        if k_enc:
            x_perm = a.transpose(0, 1)          # (C, N, H, W)
            g_perm = grad.transpose(0, 1)       # (O, N, oH, oW), the kernel
            gk = x_perm.conv2d(
                g_perm, stride=dilation, padding=padding, dilation=stride
            )
            gk = gk.transpose(0, 1)
            if _shape_of(gk)[-2:] != tuple(kshape[-2:]):
                gk = gk.narrow(-2, 0, kshape[-2]).narrow(-1, 0, kshape[-1])
        return (ga, gk)


@register_function("conv1d")
class AutogradConv1d(AutogradFunction):
    @staticmethod
    def forward(ctx, a, kernel, stride=1, padding=0, dilation=1, groups=1):
        ctx.save_multiple_for_backward(
            [a, kernel, _is_enc(kernel), stride, padding, dilation, groups]
        )
        return a.conv1d(kernel, stride=stride, padding=padding,
                        dilation=dilation, groups=groups)

    @staticmethod
    def backward(ctx, grad):
        a, kernel, k_enc, stride, padding, dilation, groups = ctx.saved_tensors
        if groups != 1:
            raise NotImplementedError("grouped conv backward")
        ga = grad.conv_transpose1d(
            kernel, stride=stride, padding=padding, dilation=dilation
        )
        ashape = _shape_of(a)
        if _shape_of(ga)[-1] != ashape[-1]:
            ga = ga.narrow(-1, 0, ashape[-1])
        gk = None
        if k_enc:
            kshape = _shape_of(kernel)
            x_perm = a.transpose(0, 1)
            g_perm = grad.transpose(0, 1)
            gk = x_perm.conv1d(
                g_perm, stride=dilation, padding=padding, dilation=stride
            )
            gk = gk.transpose(0, 1)
            if _shape_of(gk)[-1] != kshape[-1]:
                gk = gk.narrow(-1, 0, kshape[-1])
        return (ga, gk)


@register_function("avg_pool2d")
class AutogradAvgPool2d(AutogradFunction):
    @staticmethod
    def forward(ctx, a, kernel_size, stride=None, padding=0, ceil_mode=False):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size, kernel_size)
        if stride is None:
            stride = kernel_size
        if isinstance(stride, int):
            stride = (stride, stride)
        if isinstance(padding, int):
            padding = (padding, padding)
        ctx.save_multiple_for_backward(
            [_shape_of(a), kernel_size, stride, padding]
        )
        return a.avg_pool2d(kernel_size, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        # each output gradient spread evenly over its window: a transposed
        # convolution by a public channel-identity averaging kernel
        shape, k, s, p = ctx.saved_tensors
        n_ch = shape[1]
        kernel = np.einsum("oi,hw->oihw", np.eye(n_ch), np.ones((k[0], k[1]))) / (k[0] * k[1])
        ga = grad.conv_transpose2d(kernel, stride=s, padding=p)
        if _shape_of(ga)[-2:] != tuple(shape[-2:]):
            ga = ga.narrow(-2, 0, shape[-2]).narrow(-1, 0, shape[-1])
        return ga


@register_function("max_pool2d")
class AutogradMaxPool2d(AutogradFunction):
    @staticmethod
    def forward(ctx, a, kernel_size, padding=0, stride=None, dilation=1,
                ceil_mode=False, return_indices=False):
        out, indices = a.max_pool2d(
            kernel_size, padding=padding, stride=stride, dilation=dilation,
            ceil_mode=ceil_mode, return_indices=True,
        )
        ctx.save_multiple_for_backward(
            [_shape_of(a), indices, kernel_size, padding, stride, dilation, ceil_mode]
        )
        ctx.mark_non_differentiable(indices)
        if return_indices:
            return out, indices
        return out

    @staticmethod
    def backward(ctx, grad):
        shape, indices, k, p, s, d, cm = ctx.saved_tensors
        return grad._max_pool2d_backward(
            indices, k, padding=p, stride=s, dilation=d, ceil_mode=cm,
            output_size=shape,
        )


# -- normalization -----------------------------------------------------------

@register_function("layernorm")
class AutogradLayerNorm(AutogradFunction):
    """The forward of reference gradients.py:1956; the backward the
    standard LayerNorm gradient, which the JAX package completed where the
    reference leaves it out (gradients.py:886)."""

    @staticmethod
    def forward(ctx, x, weight, bias, training=True, eps=1e-5, inv_var=None, dims=1):
        axes = tuple(range(x.dim() - dims, x.dim()))
        mean = x.mean(axis=axes, keepdim=True)
        variance = x.var(axis=axes, keepdim=True)
        inv = (variance.add(eps)).inv_sqrt()
        xhat = x.sub(mean).mul(inv)
        ctx.save_multiple_for_backward([xhat, inv, weight, axes])
        return xhat.mul(weight).add(bias)

    @staticmethod
    def backward(ctx, grad):
        xhat, inv, weight, axes = ctx.saved_tensors
        n = int(np.prod([_shape_of(xhat)[a] for a in axes]))
        gxhat = grad.mul(weight)
        t1 = gxhat.mul(n)
        t2 = gxhat.sum(axis=axes, keepdim=True)
        t3 = xhat.mul(gxhat.mul(xhat).sum(axis=axes, keepdim=True))
        gx = inv.div(n).mul(t1.sub(t2).sub(t3))
        gw = grad.mul(xhat)
        gb = grad
        lead = tuple(range(len(_shape_of(xhat)) - len(axes)))
        if lead:
            gw = gw.sum(axis=lead)
            gb = gb.sum(axis=lead)
        return (gx, gw, gb)


@register_function("getitem")
class AutogradGetItem(AutogradFunction):
    @staticmethod
    def forward(ctx, a, idx):
        ctx.save_multiple_for_backward([_shape_of(a), idx])
        return a[idx]

    @staticmethod
    def backward(ctx, grad):
        shape, idx = ctx.saved_tensors
        out = _zeros_like_with(grad, shape)
        # the gradient added into the indexed slots
        share = out.share.clone()
        share[(slice(None),) + _as_index_tuple(idx)] += grad.share
        return type(out)(out._tensor.with_share(share), out.ptype)


def _as_index_tuple(idx):
    return idx if isinstance(idx, tuple) else (idx,)


# the reference's dunder name for the same function (gradients.py:456)
FUNCTION_REGISTRY["__getitem__"] = AutogradGetItem


# -- the rest of the reference's surface (gradients.py:158-2161) --------------

@register_function("clone")
class AutogradClone(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        return a.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad.clone()


@register_function("flip")
class AutogradFlip(AutogradFunction):
    @staticmethod
    def forward(ctx, a, dims):
        ctx.save_for_backward(dims)
        return a.flip(dims)

    @staticmethod
    def backward(ctx, grad):
        (dims,) = ctx.saved_tensors
        return grad.flip(dims)


@register_function("take")
class AutogradTake(AutogradFunction):
    @staticmethod
    def forward(ctx, a, index, dim=None):
        ctx.save_multiple_for_backward([_shape_of(a), index, dim])
        return a.take(index, dim)

    @staticmethod
    def backward(ctx, grad):
        shape, index, dim = ctx.saved_tensors
        index = np.asarray(index)
        out = _zeros_like_with(grad, shape)
        if dim is None:
            flat = out.view(int(np.prod(shape)))
            flat = flat.index_add(0, index.reshape(-1), grad.view(index.size))
            return flat.view(*shape)
        return out.index_add(dim, index.reshape(-1), grad)


@register_function("scatter")
class AutogradScatter(AutogradFunction):
    @staticmethod
    def forward(ctx, a, dim, index, src):
        ctx.save_multiple_for_backward([dim, index])
        return a.scatter(dim, index, src)

    @staticmethod
    def backward(ctx, grad):
        dim, index = ctx.saved_tensors
        index = np.asarray(index)
        mask = np.ones(_shape_of(grad))
        dims = list(np.meshgrid(*[np.arange(s) for s in index.shape], indexing="ij"))
        dims[dim] = index
        mask[tuple(dims)] = 0.0
        input_grad = grad.mul(mask)
        src_grad = grad.gather(dim, index)
        return (input_grad, src_grad)


@register_function("trace")
class AutogradTrace(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(_shape_of(a)[0])
        return a.trace()

    @staticmethod
    def backward(ctx, grad):
        (n,) = ctx.saved_tensors
        return grad.mul(np.eye(n))


@register_function("cat")
class AutogradCat(AutogradFunction):
    @staticmethod
    def forward(ctx, tensors, dim=0):
        sections = [_shape_of(t)[dim] for t in tensors]
        ctx.save_multiple_for_backward([dim, sections])
        return _module_cat(tensors, dim)

    @staticmethod
    def backward(ctx, grad):
        dim, sections = ctx.saved_tensors
        return tuple(grad.split(sections, dim=dim))


@register_function("stack")
class AutogradStack(AutogradFunction):
    @staticmethod
    def forward(ctx, tensors, dim=0):
        ctx.save_for_backward(dim)
        return _module_stack(tensors, dim)

    @staticmethod
    def backward(ctx, grad):
        (dim,) = ctx.saved_tensors
        return tuple(grad.unbind(dim=dim))


def _module_cat(tensors, dim):
    from .mpc.mpc import MPCTensor

    return MPCTensor.cat(list(tensors), axis=dim)


def _module_stack(tensors, dim):
    from .mpc.mpc import MPCTensor

    return MPCTensor.stack(list(tensors), axis=dim)


@register_function("__rsub__")
class AutogradRSub(AutogradFunction):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_multiple_for_backward([_shape_of(a), _shape_of(b), _is_enc(b)])
        return a.neg().add(b)

    @staticmethod
    def backward(ctx, grad):
        sa, sb, b_enc = ctx.saved_tensors
        ga = _reduce_broadcast(grad.neg(), sa)
        gb = _reduce_broadcast(grad, sb) if b_enc else None
        return (ga, gb)


@register_function("__rtruediv__")
class AutogradRDiv(AutogradFunction):
    """other / self by the reciprocal LUT (reference gradients.py:828)."""

    @staticmethod
    def forward(ctx, a, b):
        recip = a.reciprocal()
        ctx.save_multiple_for_backward([recip, b, _is_enc(b)])
        return recip.mul(b)

    @staticmethod
    def backward(ctx, grad):
        recip, b, b_enc = ctx.saved_tensors
        ga = recip.square().mul(b).mul(grad).neg()
        ga = _reduce_broadcast(ga, _shape_of(recip))
        if b_enc:
            gb = _reduce_broadcast(recip.mul(grad), _shape_of(b))
            return (ga, gb)
        return (ga, None)


@register_function("sin")
class AutogradSin(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        cos, sin = a.cossin()
        ctx.save_for_backward(cos)
        return sin

    @staticmethod
    def backward(ctx, grad):
        (cos,) = ctx.saved_tensors
        return grad.mul(cos)


@register_function("cos")
class AutogradCos(AutogradFunction):
    @staticmethod
    def forward(ctx, a):
        cos, sin = a.cossin()
        ctx.save_for_backward(sin)
        return cos

    @staticmethod
    def backward(ctx, grad):
        (sin,) = ctx.saved_tensors
        return grad.mul(sin.neg())


@register_function("sign")
class AutogradSign(AutogradFunction):
    """Zero gradient everywhere (reference gradients.py:1096)."""

    @staticmethod
    def forward(ctx, a):
        return a.sign()

    @staticmethod
    def backward(ctx, grad):
        return grad.sub(grad)


@register_function("ger")
class AutogradGer(AutogradFunction):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_multiple_for_backward([a, b, _is_enc(b)])
        return a.ger(b)

    @staticmethod
    def backward(ctx, grad):
        a, b, b_enc = ctx.saved_tensors
        ga = grad.matmul(b)
        gb = a.matmul(grad) if b_enc else None
        return (ga, gb)


@register_function("relu6")
class AutogradReLU6(AutogradFunction):
    """min(max(0, x), 6) by two stacked comparisons (reference
    gradients.py:646)."""

    @staticmethod
    def forward(ctx, a):
        inter = _module_stack([a, a.neg().add(6)], 0).gt(0)
        parts = inter.unbind(0)
        grad_mask = parts[0].add(parts[1]).sub(1)
        ctx.save_for_backward(grad_mask)
        result = grad_mask.mul(a)
        return result.add(parts[1].neg().add(1).mul(6))

    @staticmethod
    def backward(ctx, grad):
        (grad_mask,) = ctx.saved_tensors
        return grad.mul(grad_mask)


@register_function("polynomial")
class AutogradPolynomial(AutogradFunction):
    @staticmethod
    def forward(ctx, a, coeffs, func="mul"):
        coeffs = np.asarray(coeffs, dtype=np.float64)
        ctx.save_multiple_for_backward([a, coeffs, func])
        return a.polynomial(coeffs, func)

    @staticmethod
    def backward(ctx, grad):
        a, coeffs, func = ctx.saved_tensors
        # d/dx sum_i c_i x^(i+1) = sum_i (i+1) c_i x^i
        dcoeffs = coeffs * np.arange(1, coeffs.shape[0] + 1)
        if dcoeffs.shape[0] == 1:
            return grad.mul(float(dcoeffs[0]))
        return a.polynomial(dcoeffs[1:], func).add(float(dcoeffs[0])).mul(grad)


@register_function("pos_pow")
class AutogradPosPow(AutogradFunction):
    """x^p for x > 0: integer p by pow, fractional by exp(p log x)
    (reference gradients.py:882)."""

    @staticmethod
    def forward(ctx, a, p):
        if isinstance(p, int) or (isinstance(p, float) and int(p) == p):
            ctx.save_multiple_for_backward([a, p, True])
            return a.pow(int(p))
        log_a = a.log()
        ctx.save_multiple_for_backward([log_a, p, False])
        return log_a.mul(p).exp()

    @staticmethod
    def backward(ctx, grad):
        saved, p, integral = ctx.saved_tensors
        if integral:
            return saved.pow(int(p) - 1).mul(p).mul(grad)
        # d/dx x^p = p exp((p - 1) log x); saved = log x
        return saved.mul(p - 1.0).exp().mul(p).mul(grad)


@register_function("cosine_similarity")
class AutogradCosineSimilarity(AutogradFunction):
    @staticmethod
    def forward(ctx, x1, x2, dim=1, eps=None):
        assert _shape_of(x1) == _shape_of(x2), "cosine_similarity sizes must match"
        xy = _module_stack([x1, x2], 0)  # (2, ...)
        norm_sq = xy.square().sum(axis=dim + 1)
        inv_norms = norm_sq.inv_sqrt()
        ctx.save_multiple_for_backward([xy, inv_norms, dim])
        inv_norm = inv_norms.prod(0)
        dot = xy.prod(0).sum(dim)
        return dot.mul(inv_norm)

    @staticmethod
    def backward(ctx, grad):
        xy, inv_norms, dim = ctx.saved_tensors
        dot = xy.prod(0).sum(dim, keepdim=True)
        inv_norms = inv_norms.unsqueeze(dim + 1)
        sq_inv_norms = inv_norms.square()
        xy_normalized = xy.mul(sq_inv_norms)
        yx = xy.roll(1, 0)
        grads = yx.sub(dot.mul(xy_normalized)).mul(inv_norms.prod(0))
        grads = grads.mul(grad.unsqueeze(dim))
        x_grad, y_grad = grads.unbind(0)
        return (x_grad, y_grad)


@register_function("norm")
class AutogradNorm(AutogradFunction):
    @staticmethod
    def forward(ctx, a, p="fro", dim=None, keepdim=False):
        if p == float("inf"):
            sign = a.sign()
            absval = a.mul(sign)
            if dim is None:
                argmax = absval.argmax(one_hot=True)
                mx = absval.mul(argmax).sum()
            else:
                mx, argmax = absval.max(dim, keepdim=keepdim, one_hot=True)
            ctx.save_multiple_for_backward([sign, argmax, p, dim, keepdim])
            return mx
        norm = a.norm(p=p, dim=dim, keepdim=keepdim) if dim is not None else a.norm(p=p)
        ctx.save_multiple_for_backward([a, norm, p, dim, keepdim])
        return norm

    @staticmethod
    def backward(ctx, grad):
        a, norm, p, dim, keepdim = ctx.saved_tensors
        if not keepdim and dim is not None:
            grad = grad.unsqueeze(dim)
            if p != float("inf"):
                norm = norm.unsqueeze(dim)
        if p == 2 or p == "fro":
            return grad.mul(a.div(norm))
        if p == float("inf"):
            sign, argmax = a, norm
            return grad.mul(argmax).mul(sign)
        sign = a.sign()
        absval = a.mul(sign)
        return grad.mul(absval.div(norm).pos_pow(p - 1).mul(sign))


@register_function("_feature_dropout")
class AutogradFeatureDropout(AutogradFunction):
    """Zero whole channels (dims 2+) with probability p (reference
    gradients.py:533)."""

    @staticmethod
    def forward(ctx, a, p=0.5, training=True, inplace=False):
        if not training or p == 0.0:
            ctx.save_for_backward(None)
            return a.clone()
        mask = type(a).rand(*_shape_of(a)[:2]).gt(p)
        for _ in range(len(_shape_of(a)) - 2):
            mask = mask.unsqueeze(-1)
        ctx.save_multiple_for_backward([mask, p])
        return a.mul(mask).div(1 - p)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        if saved[0] is None:
            return grad
        mask, p = saved
        return grad.mul(mask).div(1 - p)


@register_function("attention")
class AutogradAttention(AutogradFunction):
    """Scaled dot-product attention (reference gradients.py:1482; the
    JAX package writes the backward the reference leaves out)."""

    @staticmethod
    def forward(ctx, query, key, value, mask=None):
        scale = 1.0 / math.sqrt(_shape_of(query)[-1])
        scores = query.matmul(key.transpose(-2, -1)).mul(scale)
        if mask is not None:
            scores = scores.add(mask)
        probs = scores.softmax(-1)
        out = probs.matmul(value)
        ctx.save_multiple_for_backward([query, key, value, probs, scale])
        return out

    @staticmethod
    def backward(ctx, grad):
        query, key, value, probs, scale = ctx.saved_tensors
        gv = probs.transpose(-2, -1).matmul(grad)
        gprobs = grad.matmul(value.transpose(-2, -1))
        # softmax backward: p * (g - sum(g * p))
        inner = gprobs.mul(probs).sum(axis=-1, keepdim=True)
        gscores = probs.mul(gprobs.sub(inner)).mul(scale)
        gq = gscores.matmul(key)
        gk = gscores.transpose(-2, -1).matmul(query)
        return (gq, gk, gv, None)


@register_function("batchnorm")
class AutogradBatchNorm(AutogradFunction):
    """Normalize over every dim but the channel dim 1 (reference
    gradients.py:1805); training by the batch's unbiased variance.

    The JAX package's training backward takes the variance's term over n,
    the gradient of the biased variance, where its forward divides by
    n - 1: its input gradient is off by up to a third of that term at n = 4
    (ROADMAP Queue C). The port divides that term by n - 1, the gradient of
    what the forward computes (the same public division, so the same rounds
    and bytes)."""

    @staticmethod
    def forward(
        ctx,
        x,
        weight,
        bias,
        running_mean=None,
        running_var=None,
        training=False,
        eps=1e-5,
        momentum=0.1,
        inv_var=None,
    ):
        ndim = len(_shape_of(x))
        stats_axes = tuple(i for i in range(ndim) if i != 1)
        broadcast_shape = [1] * ndim
        broadcast_shape[1] = _shape_of(x)[1]

        if training:
            mean = x.mean(axis=stats_axes, keepdim=True)
            variance = x.var(axis=stats_axes, keepdim=True, unbiased=True)
        else:
            if running_mean is None or running_var is None:
                raise ValueError(
                    "running_mean and running_var required when training=False"
                )
            mean = _as_broadcast(running_mean, broadcast_shape)
            variance = _as_broadcast(running_var, broadcast_shape)

        if training or inv_var is None:
            if _is_enc(variance):
                inv_var = (variance.add(eps)).inv_sqrt()
            else:
                inv_var = 1.0 / np.sqrt(np.asarray(variance) + eps)

        weight = _as_broadcast(weight, broadcast_shape)
        bias = _as_broadcast(bias, broadcast_shape)
        x_norm = x.sub(mean).mul(inv_var)
        ctx.save_multiple_for_backward([x_norm, weight, inv_var, training])
        return x_norm.mul(weight).add(bias)

    @staticmethod
    def backward(ctx, grad):
        x_norm, weight, inv_var, training = ctx.saved_tensors
        ndim = len(_shape_of(grad))
        stats_axes = tuple(i for i in range(ndim) if i != 1)

        grad_weight = grad.mul(x_norm).sum(axis=stats_axes)
        grad_bias = grad.sum(axis=stats_axes)

        gout = grad.mul(weight)
        grad_input = gout.mul(inv_var)
        if training:
            n = int(np.prod([_shape_of(gout)[d] for d in stats_axes]))
            grad_mean = gout.sum(axis=stats_axes, keepdim=True)
            grad_mean = grad_mean.mul(_div_scalar(inv_var, -n))
            grad_std = x_norm.mul(gout).sum(axis=stats_axes, keepdim=True)
            grad_std = x_norm.mul(grad_std).mul(_div_scalar(inv_var, -(n - 1)))
            grad_input = grad_input.add(grad_mean).add(grad_std)
        return (grad_input, grad_weight, grad_bias)


def _as_broadcast(t, shape):
    if _is_enc(t):
        return t.view(*shape)
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64).reshape(shape)


def _div_scalar(t, s):
    if _is_enc(t):
        # the ring's truncation divides by positive integers: the sign by neg
        return t.div(abs(s)).neg() if s < 0 else t.div(s)
    return np.asarray(t) / s


# -- losses (reference gradients.py:2036-2161) --------------------------------

def _one_minus(t):
    return t.neg().add(1.0) if _is_enc(t) else 1.0 - t


@register_function("binary_cross_entropy")
class AutogradBinaryCrossEntropy(AutogradFunction):
    @staticmethod
    def forward(ctx, pred, target, skip_forward=False):
        ctx.mark_non_differentiable(target)
        ctx.save_multiple_for_backward([pred, target])
        if skip_forward:
            return pred.sub(pred).sum()  # an encrypted zero scalar
        stacked = _module_stack([pred, pred.neg().add(1.0)], 0)
        log_pos, log_neg = stacked.log(input_in_01=True).unbind(0)
        t = target if _is_enc(target) else _public(target)
        loss = log_pos.mul(t).add(log_neg.mul(_one_minus(t)))
        return loss.mean().neg()

    @staticmethod
    def backward(ctx, grad):
        pred, target = ctx.saved_tensors
        stacked = _module_stack([pred, pred.neg().add(1.0)], 0)
        rec_pos, rec_neg = stacked.reciprocal(input_in_01=True).unbind(0)
        t = target if _is_enc(target) else _public(target)
        g = rec_neg.mul(_one_minus(t)).sub(rec_pos.mul(t))
        n = int(np.prod(_shape_of(pred)))
        return (g.div(n).mul(grad), None)


@register_function("binary_cross_entropy_with_logits")
class AutogradBinaryCrossEntropyWithLogits(AutogradFunction):
    @staticmethod
    def forward(ctx, logit, target, skip_forward=False):
        sigmoid_out = logit.sigmoid()
        ctx.mark_non_differentiable(target)
        ctx.save_multiple_for_backward([target, sigmoid_out])
        if skip_forward:
            return logit.sub(logit).sum()
        stacked = _module_stack([sigmoid_out, sigmoid_out.neg().add(1.0)], 0)
        log_pos, log_neg = stacked.log(input_in_01=True).unbind(0)
        t = target if _is_enc(target) else _public(target)
        loss = log_pos.mul(t).add(log_neg.mul(_one_minus(t)))
        return loss.mean().neg()

    @staticmethod
    def backward(ctx, grad):
        target, sigmoid_out = ctx.saved_tensors
        t = target if _is_enc(target) else _public(target)
        n = int(np.prod(_shape_of(sigmoid_out)))
        return (sigmoid_out.sub(t).div(n).mul(grad), None)


@register_function("rappor_loss")
class AutogradRAPPORLoss(AutogradFunction):
    """Randomized-response BCE: p' = alpha p + (1 - alpha)(1 - p)
    (reference gradients.py:2090)."""

    @staticmethod
    def forward(ctx, logit, target, alpha, skip_forward=False):
        pred = logit.sigmoid()
        ctx.mark_non_differentiable(target)
        if alpha == 0.0:
            pred_normalized = pred
            ctx.save_multiple_for_backward([target, pred, None, alpha])
        else:
            pred_normalized = pred.mul(alpha).add(pred.neg().add(1.0).mul(1 - alpha))
            grad_correction = pred.mul(pred.neg().add(1.0))
            grad_correction = grad_correction.mul(
                pred_normalized.mul(pred_normalized.neg().add(1.0)).reciprocal(
                    input_in_01=True
                )
            )
            ctx.save_multiple_for_backward(
                [target, pred_normalized, grad_correction, alpha]
            )
        if skip_forward:
            return logit.sub(logit).sum()
        stacked = _module_stack(
            [pred_normalized, pred_normalized.neg().add(1.0)], 0
        )
        log_pos, log_neg = stacked.log(input_in_01=True).unbind(0)
        t = target if _is_enc(target) else _public(target)
        loss = log_pos.mul(t).add(log_neg.mul(_one_minus(t)))
        return loss.mean().neg()

    @staticmethod
    def backward(ctx, grad):
        target, pred_normalized, grad_correction, alpha = ctx.saved_tensors
        t = target if _is_enc(target) else _public(target)
        n = int(np.prod(_shape_of(pred_normalized)))
        if alpha == 0.0:
            return (pred_normalized.sub(t).div(n).mul(grad), None, None)
        g = pred_normalized.sub(t).div(n).mul(2 * alpha - 1).mul(grad_correction)
        return (g.mul(grad), None, None)


@register_function("cross_entropy")
class AutogradCrossEntropy(AutogradFunction):
    @staticmethod
    def forward(ctx, pred, target, skip_forward=False):
        assert _shape_of(pred) == _shape_of(target), "target must be one-hot"
        dim = 1 if len(_shape_of(pred)) > 1 else 0
        sm = pred.softmax(dim)
        ctx.save_multiple_for_backward([sm, target])
        ctx.mark_non_differentiable(target)
        if skip_forward:
            return pred.sub(pred).sum()
        t = target if _is_enc(target) else _public(target)
        loss = sm.log(input_in_01=True).mul(t).neg()
        return loss.sum().div(_shape_of(pred)[0])

    @staticmethod
    def backward(ctx, grad):
        sm, target = ctx.saved_tensors
        t = target if _is_enc(target) else _public(target)
        return (sm.sub(t).div(_shape_of(sm)[0]).mul(grad), None)


# -- installation --------------------------------------------------------------

# the functions whose forward exists only here, made methods of MPCTensor
# (each its function's forward) before the dispatch is installed
_FORWARD_METHODS = ("scatter", "relu6", "cosine_similarity", "_feature_dropout", "attention",
                    "batchnorm", "layernorm", "getitem", "binary_cross_entropy",
                    "binary_cross_entropy_with_logits", "rappor_loss", "cross_entropy")


def _forward_method(name):
    fn = FUNCTION_REGISTRY[name]

    def method(self, *args, **kwargs):
        return fn.forward(AutogradContext(), self, *args, **kwargs)

    method.__name__ = name
    method.__doc__ = f"The forward of ``gradients.{fn.__name__}``."
    return method


def install():
    """Install the autograd dispatch on MPCTensor (after ``functions`` has
    put its ops there)."""
    from .autograd import install_autograd
    from .mpc.mpc import MPCTensor

    for name in _FORWARD_METHODS:
        if name not in MPCTensor.__dict__:
            setattr(MPCTensor, name, _forward_method(name))
    install_autograd(MPCTensor)
