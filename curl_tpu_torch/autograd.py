"""Define-by-run autograd over encrypted tensors.

Counterpart of ``curl_tpu/autograd.py`` (the reference's
curl/cryptensor.py:216-459). Each backward formula is itself an MPC
program, so every gradient product is a Beaver round, as in the JAX
package. ``install_autograd(MPCTensor)`` wraps each op named in
``FUNCTION_REGISTRY`` (``gradients.py``) with a dispatcher that records a
tape node when grad mode is on and an operand requires grad, and rebinds
the operator dunders, which were bound to the plain methods when the class
was made.

The port has one encrypted tensor, the party-stacked ``MPCTensor``, and
its tape is the JAX package's eager CrypTensor tape: a step run eagerly and
the same step captured by ``parallel.compile_parties`` build the same tape.
As there (curl_tpu/__init__.py:334-363), an op that is not in the registry
(inv_sqrt, split, a comparison, ...) runs off the tape: its output does not
require grad, and no gradient flows back through it.

The same dispatch records each op inside a lazy scope (``lazy.py``), where
the JAX package's ``_eager_run`` does (curl_tpu/__init__.py:156-159): a
plain call (no operand requires grad, or grad mode is off) and every
off-tape op is recorded instead of run, and so are ``__getitem__`` and
``__mod__``, which are bound to their plain methods. An autograd op runs
its bookkeeping at once, and the ops its forward, and later its backward,
call are recorded: a training step in a scope builds its tape over pending
tensors.
"""

from __future__ import annotations

import threading

import torch

from . import lazy  # the module (the package later exports its ``lazy()`` by that name)

_grad_mode = threading.local()


def is_grad_enabled():
    return getattr(_grad_mode, "enabled", True)


class no_grad:
    def __enter__(self):
        self.prev = is_grad_enabled()
        _grad_mode.enabled = False
        return self

    def __exit__(self, *exc):
        _grad_mode.enabled = self.prev

    def __call__(self, fn):
        def wrapped(*a, **k):
            with no_grad():
                return fn(*a, **k)

        return wrapped


class enable_grad:
    def __enter__(self):
        self.prev = is_grad_enabled()
        _grad_mode.enabled = True
        return self

    def __exit__(self, *exc):
        _grad_mode.enabled = self.prev


FUNCTION_REGISTRY = {}


def register_function(name):
    def wrap(cls):
        FUNCTION_REGISTRY[name] = cls
        return cls

    return wrap


class AutogradContext:
    """What a forward keeps for its backward (reference gradients.py:108)."""

    def __init__(self):
        self.context = []
        self.non_differentiable = []

    def save_for_backward(self, value):
        self.context.append(value)

    def save_multiple_for_backward(self, values):
        self.context.extend(values)

    def mark_non_differentiable(self, non_diff):
        if not isinstance(non_diff, list):
            non_diff = [non_diff]
        self.non_differentiable.extend(id(x) for x in non_diff)

    def is_differentiable(self, value):
        return id(value) not in self.non_differentiable

    @property
    def saved_tensors(self):
        return self.context


class AutogradFunction:
    differentiable = True

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, grad_output):
        raise NotImplementedError


def _is_tensor_like(x):
    # the class, not the instance: ``share`` is a property
    return hasattr(type(x), "share")


def _tensor_args(args):
    """The tensors among ``args``, those of a list or tuple argument (cat,
    stack) each in turn."""
    for a in args:
        if _is_tensor_like(a):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if _is_tensor_like(t))


def _requires_grad(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            if any(getattr(t, "requires_grad", False) for t in a if _is_tensor_like(t)):
                return True
        elif getattr(a, "requires_grad", False) and _is_tensor_like(a):
            return True
    return False


def _encrypt_ones(shape):
    """Encrypted ones of ``shape``, made on the session's device (nothing
    copied from the host, so that a captured backward can seed itself)."""
    from . import comm
    from .mpc.mpc import MPCTensor

    return MPCTensor.encrypt(torch.ones(shape, dtype=torch.float64, device=comm.get_device()))


class _Node:
    """A backward-graph node: the function, its context and its inputs."""

    __slots__ = ("fn", "ctx", "inputs")

    def __init__(self, fn, ctx, inputs):
        self.fn = fn
        self.ctx = ctx
        self.inputs = inputs


def _wrap_method(cls, name, plain_method):
    def dispatched(self, *args, **kwargs):
        if (getattr(self, "requires_grad", False) or _requires_grad(args)) and is_grad_enabled():
            return apply_function(name, self, *args, **kwargs)
        if lazy._tape is not None:
            return lazy._tape.record(plain_method, (self,) + args, kwargs)
        return plain_method(self, *args, **kwargs)

    dispatched.__name__ = name
    dispatched.__doc__ = plain_method.__doc__
    setattr(cls, name, dispatched)


def _wrap_off_tape(cls, name, plain_method):
    def off_tape(self, *args, **kwargs):
        if lazy._tape is not None:  # recorded ops run off the tape at the flush
            return lazy._tape.record(plain_method, (self,) + args, kwargs)
        if (getattr(self, "requires_grad", False) or _requires_grad(args)) and is_grad_enabled():
            with no_grad():
                return plain_method(self, *args, **kwargs)
        return plain_method(self, *args, **kwargs)

    off_tape.__name__ = name
    off_tape.__doc__ = plain_method.__doc__
    setattr(cls, name, off_tape)


# methods that neither compute a share nor record: left as they are
_TAPE_SURFACE = ("backward", "detach", "size", "dim", "nelement", "get_plain_text", "reveal",
                 "_peek", "_assign")
# operator dunders bound to plain methods that are not autograd ops: only
# recorded in a lazy scope
_LAZY_DUNDERS = ("__getitem__", "__mod__")


def _reject_compressed_grads(args):
    """Seed-compressed shares are inference-only (autograd.py:169): a
    compressed tensor that requires grad raises as it enters the tape, since
    its expanded share has no storage for a gradient step. A compressed
    weight that does not require grad stays legal (the other operands get
    their gradients)."""
    from .mpc.primitives.compressed import SeedCompressedArithmetic

    for t in _tensor_args(args):
        if getattr(t, "requires_grad", False) and hasattr(t, "_peek") and isinstance(
                t._peek(), SeedCompressedArithmetic):
            raise RuntimeError(
                "backward through seed-compressed shares is unsupported: "
                "they are inference-only (2PC). Encrypt the parameters "
                "with seed_compress=False (materialized shares) to train."
            )


def _wrap_lazy(cls, name, plain_method):
    def recorded(self, *args):
        if lazy._tape is not None:
            return lazy._tape.record(plain_method, (self,) + args, {})
        return plain_method(self, *args)

    recorded.__name__ = name
    recorded.__doc__ = plain_method.__doc__
    setattr(cls, name, recorded)


def apply_function(name, *args, **kwargs):
    """Run a registered AutogradFunction and record the tape node."""
    _reject_compressed_grads(args)
    grad_cls = FUNCTION_REGISTRY[name]
    ctx = AutogradContext()
    with no_grad():
        result = grad_cls.forward(ctx, *args, **kwargs)
    node = _Node(grad_cls, ctx, list(_tensor_args(args)))
    multi = isinstance(result, (tuple, list))
    outs = list(result) if multi else [result]
    for i, out in enumerate(outs):
        if ctx.is_differentiable(out):
            out.requires_grad = True
            out.grad_fn = node
            out.grad_output_index = i
            out.grad_fn_outputs = len(outs) if multi else 1
    return result


def backward(tensor, grad_input=None):
    """Reverse-mode pass (reference cryptensor.py:216-282; autograd.py:
    199-290): the graph's tensors in a depth-first order, each node's
    backward run once all the gradients it expects have arrived, summed at
    fan-out, and accumulated into the leaves' ``grad``."""
    from .mpc.mpc import MPCTensor

    if grad_input is None:
        grad_input = _encrypt_ones(tuple(tensor.shape))
    elif not _is_tensor_like(grad_input):
        grad_input = MPCTensor.encrypt(grad_input)

    # 1. the graph, and how many gradients each tensor expects
    expected = {}
    visited = set()
    stack = [tensor]
    order = []
    while stack:
        t = stack.pop()
        if id(t) in visited:
            continue
        visited.add(id(t))
        order.append(t)
        node = getattr(t, "grad_fn", None)
        if node is not None:
            for inp in node.inputs:
                expected[id(inp)] = expected.get(id(inp), 0)
                stack.append(inp)
    for t in order:
        node = getattr(t, "grad_fn", None)
        if node is not None:
            for inp in node.inputs:
                expected[id(inp)] = expected.get(id(inp), 0) + 1

    # 2. the nodes, each once its gradients are in
    received = {}
    grads = {id(tensor): grad_input}
    ready = [tensor]
    processed = set()
    while ready:
        t = ready.pop()
        if id(t) in processed:
            continue
        processed.add(id(t))
        node = getattr(t, "grad_fn", None)
        grad = grads.get(id(t))
        if node is None:
            if getattr(t, "requires_grad", False) and grad is not None:
                prev = getattr(t, "grad", None)
                t.grad = grad if prev is None else prev.add(grad)
            continue
        with no_grad():
            in_grads = node.fn.backward(node.ctx, grad)
        if not isinstance(in_grads, (tuple, list)):
            in_grads = (in_grads,)
        for inp, g in zip(node.inputs, in_grads):
            if g is None:
                continue
            grads[id(inp)] = grads[id(inp)].add(g) if id(inp) in grads else g
            received[id(inp)] = received.get(id(inp), 0) + 1
            if received[id(inp)] >= expected.get(id(inp), 1):
                ready.append(inp)

    # leaves whose gradients never completed their count
    for t in order:
        if (
            getattr(t, "requires_grad", False)
            and getattr(t, "grad_fn", None) is None
            and id(t) in grads
            and getattr(t, "grad", None) is None
        ):
            t.grad = grads[id(t)]


_OPERATOR_ALIASES = {
    "__add__": "add",
    "__radd__": "add",
    "__sub__": "sub",
    "__mul__": "mul",
    "__rmul__": "mul",
    "__matmul__": "matmul",
    "__truediv__": "div",
    "__neg__": "neg",
}


def install_autograd(cls):
    """Wrap the registered ops of ``cls`` with autograd dispatch and its
    other methods to run off the tape, rebind its operator dunders to the
    wrapped ops, and add ``backward`` and ``detach`` (autograd.py:
    304-351)."""
    for name in FUNCTION_REGISTRY:
        plain = getattr(cls, name, None)
        if plain is not None and callable(plain):
            _wrap_method(cls, name, plain)
    for name, attr in list(vars(cls).items()):
        if (name.startswith("__") or name in FUNCTION_REGISTRY or name in _TAPE_SURFACE
                or not callable(attr) or isinstance(attr, (staticmethod, classmethod))):
            continue
        _wrap_off_tape(cls, name, attr)

    for name in _LAZY_DUNDERS:
        plain = getattr(cls, name, None)
        if plain is not None:
            _wrap_lazy(cls, name, plain)

    # the dunders were bound to the plain methods: without this, ``x + y``
    # would bypass the tape
    for dunder, target in _OPERATOR_ALIASES.items():
        if hasattr(cls, dunder) and target in FUNCTION_REGISTRY:

            def _op(self, *args, _t=target):
                return getattr(self, _t)(*args)

            _op.__name__ = dunder
            setattr(cls, dunder, _op)

    def backward_method(self, grad_input=None):
        return backward(self, grad_input)

    cls.backward = backward_method

    def detach(self):
        """The same shares off the tape: no gradient flows back through it."""
        with no_grad():
            out = self.clone()
        out.requires_grad = False
        out.grad_fn = None
        return out

    if not hasattr(cls, "detach"):
        cls.detach = detach
