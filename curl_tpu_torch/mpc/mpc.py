"""MPCTensor: ptype-dispatching facade over the share primitives.

Counterpart of ``curl_tpu/mpc/mpc.py``. Wraps an ArithmeticSharedTensor or
BinarySharedTensor whose share carries the explicit party axis, converts
between them (A2B/B2A) and hosts the sign primitive ``_ltz`` and the
equality ``eq`` / ``ne`` (the 2-party ``_eqz_2PC``). The function
library (``curl_tpu_torch.functions``) installs its ops on this class at
import, as the JAX package does. It is also the port's user-facing
encrypted tensor (``curl_tpu_torch.CrypTensor``): the shares of all parties
are already stacked, so no per-party trace is needed.

Inside a lazy scope (``lazy.py``) an op hands out a *pending* MPCTensor: it
holds no inner tensor yet, only its tape's record and the op's abstract
result (an inner tensor whose share lies on the ``meta`` device). Shape,
ptype, encoder and ``repr`` are served from that; the inner tensor itself
(``_tensor``: ``share``, every reveal, every op run outside a scope) flushes
the tape first (curl_tpu/__init__.py:246-270).
"""

from __future__ import annotations

import math

import torch

from .. import comm
from ..encoder import FixedPointEncoder
from .primitives import converters
from .primitives.arithmetic import ArithmeticSharedTensor
from .primitives.binary import BinarySharedTensor
from .ptype import ptype as Ptype


def _compare_bits() -> int:
    """Comparison ring width (cfg.mpc.compare_bits, default 32)."""
    from ..config import cfg

    try:
        width = int(cfg.mpc.compare_bits)
    except (AttributeError, TypeError, ValueError):
        return 32
    return width if width in (16, 32) else 64


def _use_fused_compare(x) -> bool:
    """cfg.mpc.fused_compare = "cuda": _ltz, the funnel of every comparison,
    as one fused pass (``kernels/max_step.fused_ltz_mpc``): 2 parties, the
    packed 32-bit comparison ring the pass implements, and at least
    MIN_ELEMENTS elements (smaller tensors stay on the composable path)."""
    from .. import comm
    from ..config import cfg
    from ..kernels import max_step

    return (
        getattr(cfg.mpc, "fused_compare", None) == "cuda"
        and _compare_bits() == 32
        and x.nelement() >= max_step.MIN_ELEMENTS
        and comm.get_world_size() == 2
    )


def _pack_narrow(share, width):
    """Pack 64/width consecutive elements' low ``width`` bits into one word
    per party: (P, *shape) -> (P, ceil(n / lanes)). Shares of a mod-2^64
    secret reduce to shares of it mod 2^width, and circuit.add keeps the
    segments independent."""
    lanes = 64 // width
    P = share.shape[0]
    orig_shape = tuple(share.shape[1:])
    n = math.prod(orig_shape)
    flat = share.reshape(P, n)
    pad = (-n) % lanes
    if pad:
        flat = torch.cat([flat, flat.new_zeros(P, pad)], dim=1)
    grp = flat.reshape(P, -1, lanes)
    maskw = (1 << width) - 1
    packed = grp[..., 0] & maskw
    for lane in range(1, lanes):
        packed = packed | ((grp[..., lane] & maskw) << (lane * width))
    return packed, (orig_shape, n)


def _unpack_lanes(word, width, meta, lane_bit):
    """Bit ``lane_bit`` of each width-lane segment, back in element order."""
    orig_shape, n = meta
    lanes = 64 // width
    cols = [(word >> (lane * width + lane_bit)) & 1 for lane in range(lanes)]
    P = word.shape[0]
    flat = torch.stack(cols, dim=-1).reshape(P, -1)[:, :n]
    return flat.reshape((P,) + orig_shape)


class MPCTensor:
    __slots__ = (
        "_inner",
        # a pending tensor's record (``lazy.Pending``), else None
        "_lazy",
        "ptype",
        # the autograd tape's fields (mpc.py:106-122): Python-side, set by
        # ``autograd.apply_function`` and ``backward``, never part of a
        # compiled runner's arguments
        "requires_grad",
        "grad",
        "grad_fn",
        "grad_output_index",
        "grad_fn_outputs",
        "__weakref__",
    )

    def __init__(self, tensor, ptype=Ptype.arithmetic):
        self._inner = tensor
        self._lazy = None
        self.ptype = ptype
        self.requires_grad = False
        self.grad = None
        self.grad_fn = None

    @classmethod
    def _pending(cls, record, ptype):
        """A pending output of a lazy scope: ``record`` its ``lazy.Pending``
        (with the op's abstract inner tensor)."""
        t = cls.__new__(cls)
        t._inner = None
        t._lazy = record
        t.ptype = ptype
        t.requires_grad = False
        t.grad = None
        t.grad_fn = None
        return t

    @property
    def _tensor(self):
        """The inner share tensor; a pending tensor's tape is flushed first."""
        inner = self._inner
        if inner is None:
            self._lazy.tape.flush()
            inner = self._inner
            if inner is None:
                raise RuntimeError("the lazy flush did not fill this tensor")
        return inner

    @_tensor.setter
    def _tensor(self, value):
        self._inner = value
        self._lazy = None

    def _peek(self):
        """The inner tensor, or a pending tensor's abstract one (its share
        on the meta device), without flushing."""
        return self._inner if self._inner is not None else self._lazy.abstract

    def _assign(self, other: "MPCTensor"):
        """Hold ``other``'s value from now on, pending or not (an optimizer
        step's new parameter): no flush."""
        self.ptype = other.ptype
        if other._inner is not None:
            self._tensor = other._inner
            return
        self._inner = None
        self._lazy = other._lazy
        other._lazy.tape.hold(self)

    # -- constructors ------------------------------------------------------
    @classmethod
    def encrypt(cls, value, src: int = 0, precision=None, ptype=Ptype.arithmetic):
        if ptype == Ptype.arithmetic:
            return cls(ArithmeticSharedTensor.encrypt(value, src, precision))
        return cls(BinarySharedTensor.encrypt(value, src), Ptype.binary)

    @classmethod
    def rand(cls, *shape):
        """Uniform [0, 1): random bits at fixed-point precision, converted
        B2A (reference mpc.py:217-230)."""
        enc = FixedPointEncoder()
        bits = BinarySharedTensor.rand(shape, bits=enc.precision_bits)
        bits.encoder = enc
        return cls(bits, Ptype.binary).to_ptype(Ptype.arithmetic, bits=enc.precision_bits)

    # -- basic structure ---------------------------------------------------
    @property
    def share(self):
        return self._tensor.share

    @property
    def encoder(self):
        return self._peek().encoder

    @property
    def shape(self):
        return self._peek().shape

    @property
    def ndim(self):
        return self._peek().ndim

    def size(self, dim=None):
        return self.shape if dim is None else self.shape[dim]

    def dim(self):
        return self.ndim

    def nelement(self):
        return math.prod(self.shape)

    def __repr__(self):
        if self._inner is None:
            return f"MPCTensor(pending, shape={tuple(self.shape)}, ptype={self.ptype})"
        return f"MPCTensor({self._inner}, ptype={self.ptype})"

    def clone(self):
        return MPCTensor(self._tensor.clone(), self.ptype)

    # -- conversion --------------------------------------------------------
    def to_ptype(self, ptype, **kwargs):
        """A2B / B2A conversion (reference mpc.py:100-151)."""
        if ptype == self.ptype:
            return self
        if ptype == Ptype.binary:
            return MPCTensor(converters.A2B(self._tensor), Ptype.binary)
        precision = kwargs.pop("precision", None)
        return MPCTensor(
            converters.B2A(self._tensor, precision=precision, **kwargs), Ptype.arithmetic
        )

    # -- reveal ------------------------------------------------------------
    def reveal(self):
        return self._tensor.reveal()

    def get_plain_text(self):
        return self._tensor.get_plain_text()

    # -- comparisons core --------------------------------------------------
    def _ltz(self):
        """1 if value < 0 else 0 (reference mpc.py:233-242): A2B, sign bit,
        B2A of one bit. With cfg.mpc.compare_bits = w < 64 (default 32),
        64/w elements are packed per word first: exact whenever
        |value| < 2^(w-1) ring units. With mpc.fused_compare = "cuda" the
        whole comparison is one fused pass (``_use_fused_compare``)."""
        if _use_fused_compare(self):
            from ..kernels import max_step

            return max_step.fused_ltz_mpc(self)
        precision = 0 if self.encoder.scale == 1 else None
        width = _compare_bits()
        if width >= 64:
            b = converters.A2B(self._tensor).logical_rshift(63)
        else:
            packed, meta = _pack_narrow(self.share, width)
            b = converters.A2B(ArithmeticSharedTensor(packed, self.encoder), width=width)
            sign = _unpack_lanes(b.share, width, meta, lane_bit=width - 1)
            b = BinarySharedTensor(sign, self.encoder)
        arith = converters.B2A(b, precision=precision, bits=1)
        return MPCTensor(ArithmeticSharedTensor(arith.share, FixedPointEncoder(0)))

    def eq(self, y):
        """self == y (mpc.py:268): the 2-party equality circuit, or
        1 - ne for more parties."""
        if comm.get_world_size() == 2:
            return (self - y)._eqz_2PC()
        return -(self.ne(y)) + 1

    def ne(self, y):
        """self != y (mpc.py:273): 1 - eq for 2 parties; for more, the sum
        of ltz over the stacked difference and its negation."""
        if comm.get_world_size() == 2:
            return -(self.eq(y)) + 1
        difference = self - y
        stacked = ArithmeticSharedTensor(
            torch.stack([difference.share, -difference.share], dim=1), difference.encoder)
        ltz = MPCTensor(stacked)._ltz()
        return MPCTensor(ArithmeticSharedTensor(ltz.share.sum(dim=1), ltz.encoder))

    def _eqz_2PC(self):
        """self == 0 for 2 parties (mpc.py:286-310): party 0 XOR-shares its
        share, party 1 the negation of its own, and the AND tree checks the
        two words equal. Under cfg.mpc.compare_bits = w < 64 the words are
        packed 64 / w elements a word first: value == 0 iff value == 0 mod
        2^w, given |value| < 2^(w-1) ring units (the envelope of _ltz)."""
        from .primitives import circuit

        width = _compare_bits()
        share = self.share
        if width >= 64:
            x0 = BinarySharedTensor.encrypt(share, src=0, per_party=True)
            x1 = BinarySharedTensor.encrypt(-share, src=1, per_party=True)
            eq_bits = circuit.eq(x0, x1)
        else:
            packed_pos, meta = _pack_narrow(share, width)
            packed_neg, _ = _pack_narrow(-share, width)
            x0 = BinarySharedTensor.encrypt(packed_pos, src=0, per_party=True)
            x1 = BinarySharedTensor.encrypt(packed_neg, src=1, per_party=True)
            word = circuit._p_circuit(~(x0 ^ x1), width)
            eq_bits = BinarySharedTensor(_unpack_lanes(word.share, width, meta, lane_bit=width - 1))
        eq_bits.encoder = self.encoder
        result = converters.B2A(eq_bits, precision=0, bits=1)
        return MPCTensor(ArithmeticSharedTensor(result.share, FixedPointEncoder(0)))

    # -- arithmetic passthroughs -------------------------------------------
    def _wrap(self, result):
        return MPCTensor(result, self.ptype)

    def add(self, y):
        return self._wrap(self._tensor.add(_unwrap(y)))

    def sub(self, y):
        return self._wrap(self._tensor.sub(_unwrap(y)))

    def mul(self, y):
        return self._wrap(self._tensor.mul(_unwrap(y)))

    def matmul(self, y):
        return self._wrap(self._tensor.matmul(_unwrap(y)))

    def conv1d(self, kernel, **kwargs):
        return self._wrap(self._tensor.conv1d(_unwrap(kernel), **kwargs))

    def conv2d(self, kernel, **kwargs):
        return self._wrap(self._tensor.conv2d(_unwrap(kernel), **kwargs))

    def conv_transpose1d(self, kernel, **kwargs):
        return self._wrap(self._tensor.conv_transpose1d(_unwrap(kernel), **kwargs))

    def conv_transpose2d(self, kernel, **kwargs):
        return self._wrap(self._tensor.conv_transpose2d(_unwrap(kernel), **kwargs))

    def avg_pool2d(self, kernel_size, **kwargs):
        return self._wrap(self._tensor.avg_pool2d(kernel_size, **kwargs))

    def square(self):
        return self._wrap(self._tensor.square())

    def neg(self):
        return self._wrap(self._tensor.neg())

    def div(self, y):
        """Division (mpc.py:347): by a private divisor through its
        reciprocal, by a public value in the encoding."""
        if isinstance(y, MPCTensor):
            return self.mul(y.reciprocal())
        return self._wrap(self._tensor.div(y))

    def divmod(self, y):
        """(self // y, self % y) for a public integer y (mpc.py:354)."""
        d, r = self._tensor.divmod(y)
        return self._wrap(d), self._wrap(r)

    def mod(self, y):
        return self._wrap(self._tensor.mod(y))

    def egk_trunc_pr(self, l, m):
        return self._wrap(self._tensor.egk_trunc_pr(l, m))

    def egk_truncmod_pr(self, l, m):
        d, r = self._tensor.egk_truncmod_pr(l, m)
        return self._wrap(d), self._wrap(r)

    def evaluate_lut(self, lut):
        return self._wrap(self._tensor.evaluate_lut(lut))

    def evaluate_bior_lut(self, luts, scale, bias):
        return self._wrap(self._tensor.evaluate_bior_lut(luts, _unwrap(scale), bias))

    def evaluate_embed(self, embed):
        return self._wrap(self._tensor.evaluate_embed(_unwrap(embed)))

    def pad(self, pad_width, value=0):
        return self._wrap(self._tensor.pad(pad_width, value=value))

    def index_add(self, dim, index, tensor):
        return self._wrap(self._tensor.index_add(dim, index, _unwrap(tensor)))

    def scatter_add(self, dim, index, other):
        return self._wrap(self._tensor.scatter_add(dim, index, _unwrap(other)))

    def scatter(self, dim, index, src):
        return self._wrap(self._tensor.scatter(dim, index, _unwrap(src)))

    # operators
    __add__ = add
    __radd__ = add
    __sub__ = sub

    def __rsub__(self, y):
        """y - self for a public y (mpc.py:400)."""
        return self.neg().add(y)

    def __rtruediv__(self, y):
        """y / self for a public y (mpc.py:411): y times the private
        reciprocal."""
        return self.reciprocal().mul(y)

    __mul__ = mul
    __rmul__ = mul
    __matmul__ = matmul
    __truediv__ = div
    __neg__ = neg
    __mod__ = mod

    def __getitem__(self, idx):
        return self._wrap(self._tensor[idx])

    def __lt__(self, y):  # lt is installed by functions.logic
        return self.lt(y)

    @staticmethod
    def stack(tensors, axis=0):
        inner = type(tensors[0]._tensor).stack([t._tensor for t in tensors], axis=axis)
        return MPCTensor(inner, tensors[0].ptype)

    @staticmethod
    def cat(tensors, axis=0):
        inner = type(tensors[0]._tensor).cat([t._tensor for t in tensors], axis=axis)
        return MPCTensor(inner, tensors[0].ptype)


def _unwrap(y):
    return y._tensor if isinstance(y, MPCTensor) else y
