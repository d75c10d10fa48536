"""Beaver-triple protocols and Curl's LUT protocols, party axis explicit.

Counterpart of ``curl_tpu/mpc/primitives/beaver.py``; every protocol costs
the same rounds and bytes as there:

  mul/matmul/conv   1 batched reveal
  square            1 reveal
  truncate          1 gather + the dealer's scatter (more than 2 parties)
  egk_trunc_pr      1 reveal (EGK+20 Fig. 10)
  evaluate_lut      1 reveal, any table size
  evaluate_bior_lut 1 reveal + 1 Beaver mul + 1 EGK trunc
  evaluate_embed    1 reveal + 1 Beaver matmul
  evaluate_embed_chunked  1 reveal + 1 Beaver matmul per vocab chunk
  AND               1 batched reveal
  B2A_single_bit    1 reveal

Revealed values (epsilon, delta, the LUT shift) are public tensors without
the party axis; dealer plaintexts (a, b, c = a @ b) are too, and are
computed once. The LUTs and the embedding take the JAX package's TFP
gather forms where its gates do (``mpc.lut_fastpath``: a provider with
``generate_lut_masks``; ``mpc.fused_onehot``: TFP, Beaver, passive, 2
parties), else its tuple forms: the one-hot tuple (``generate_one_hot``),
its shift revealed, the public table rotated and dotted with it (chunked
over the elements for TFP above ``mpc.lut_chunk_elements``), and the
embedding's one-hot rotated by the shift and multiplied by the protocol's
matmul, at any number of parties.

Under ``mpc.active_security`` each Beaver product checks its triple against
a second one (the SPDZ sacrifice, beaver.py:57-75) and, where the check is
not zero, poisons c with a ``local`` draw, branch-free, so that a captured
forward makes no host sync.

A secret operand that many products reuse (a decode loop's weights, the LM
head over chunks of positions) can be Beaver-masked once
(``mask_operand``, ``MaskedArithmetic``): b drawn and delta = y - b revealed
once, each later product then draws only its input-sized a and reveals only
eps = x - a. A convolution's reconstruction ``eps * b + x * delta`` (and
a masked one's three products) is one ``ring.conv_acc``: the operands'
im2col columns in one ring-mm launch.
"""

from __future__ import annotations

import torch

from ... import comm
from ... import random as rng
from ... import ring
from ...config import cfg
from ...encoder import FixedPointEncoder
from .arithmetic import ArithmeticSharedTensor
from .compressed import SeedCompressedArithmetic
from .party import lift, rank0


def _provider():
    from .. import get_default_provider

    return get_default_provider()


def _raw(x: ArithmeticSharedTensor) -> ArithmeticSharedTensor:
    """Scale-1 view (the IgnoreEncodings context of the reference); a
    seed-compressed tensor stays compressed and a masked one masked."""
    if isinstance(x, SeedCompressedArithmetic):
        return x.with_encoder(FixedPointEncoder(0))
    if isinstance(x, MaskedArithmetic):
        return MaskedArithmetic(x.b_plain, x.b_share, x.delta, FixedPointEncoder(0))
    return ArithmeticSharedTensor(x.share, FixedPointEncoder(0))


def _opens_compressed(op, y) -> bool:
    """Whether a Beaver product opens y without expanding it: a matmul with
    a seed-compressed y under the gate of the fused kernels (2 parties, the
    TFP dealer; the Beaver protocol and passive security hold here)."""
    return (op == "matmul" and isinstance(y, SeedCompressedArithmetic)
            and comm.get_world_size() == 2 and _provider().NAME == "TFP")


def _ring_sum(op, pairs, kwargs):
    """sum_p op(x_p, w_p) in one ring-mm launch: ``matmul_acc`` of the
    products, or ``conv_acc`` of the convolutions' columns."""
    if op == "matmul":
        return ring.matmul_acc(pairs)
    return ring.conv_acc(op, pairs, **kwargs)


def _product_pairs(op, x_ndim, y_ndim, pairs):
    """The Beaver products' pairs (left share or public, right share or
    public) aligned for one launch, and the function that takes the sum
    back to the product's shape. A matmul's 1-D operand is a row (x) or a
    column (y) matrix, squeezed after, as torch.matmul treats it; a
    convolution's weight share gains a batch dim that broadcasts over the
    input's batch."""
    def party(t, ndim):  # a share, or a public operand without the party axis
        return t.dim() > ndim

    if op == "matmul":
        xv, yv = x_ndim == 1, y_ndim == 1
        nd = max(x_ndim + xv, y_ndim + yv)
        out = []
        for a, b in pairs:
            a = a.unsqueeze(-2) if xv else a
            b = b.unsqueeze(-1) if yv else b
            out.append((lift(a, nd) if party(a, x_ndim + xv) else a,
                        lift(b, nd) if party(b, y_ndim + yv) else b))

        def back(z):
            z = z.squeeze(-2) if xv else z
            return z.squeeze(-1) if yv else z

        return out, back
    return [(a, lift(b, y_ndim + 1) if party(b, y_ndim) else b) for a, b in pairs], lambda z: z


def _sacrificed(op, x, y, a, b, c, kwargs):
    """c, checked against a second triple (f, g, h) at a revealed PRSS
    multiplier t (beaver.py:57-75): rho = t a - f and sigma = b - g
    revealed, then t c - h - op(f, sigma) - op(rho, g) - op(rho, sigma),
    revealed, must be zero; where it is not, c is poisoned with a fresh
    ``local`` draw on every party (no branch: a captured forward makes no
    host sync). For an elementwise product t has a's shape and every term
    is elementwise, as in the JAX package. For a matmul or a convolution t
    is one ring element: the JAX package's elementwise terms do not
    broadcast there (a matmul of (3, 4) by (4, 2) raises) or check a wrong
    identity (a square one poisons an honest triple), so the port takes
    the same rounds with t's reveal one element wide."""
    f, g, h = _provider().generate_additive_triple(x.shape, y.shape, op, **kwargs)
    t = _raw(ArithmeticSharedTensor.PRSS(a.shape if op == "mul" else ())).reveal()
    rho = comm.all_sum(t * a.share - f.share)
    sigma = comm.all_sum(b.share - g.share)
    if op == "mul":
        nd = len(c.shape)
        check = t * c.share - h.share - sigma * lift(f.share, nd) - rho * lift(g.share, nd)
        check = comm.all_sum(check) - rho * sigma
    else:
        pairs, back = _product_pairs(op, x.ndim, y.ndim, [(f.share, sigma), (rho, g.share)])
        check = t * c.share - h.share - back(_ring_sum(op, pairs, kwargs))
        pairs, back = _product_pairs(op, x.ndim, y.ndim, [(rho, sigma)])
        check = comm.all_sum(check) - back(_ring_sum(op, pairs, kwargs))
    bad = (check != 0).any().to(torch.int64)
    return c.with_share(c.share + bad * rng.random_ring(c.shape, "local"))


def _beaver_protocol(op, x, y, **kwargs):
    """z = c + eps*b + x*delta with one batched reveal (x = a + eps, so
    this equals the reference's c + eps*b + a*delta + eps*delta). A
    seed-compressed matmul operand y is opened in one pass
    (``SeedCompressedArithmetic.open``): the same delta, rounds and bytes.
    Under active security the triple is sacrificed first (``_sacrificed``)."""
    a, b, c = _provider().generate_additive_triple(x.shape, y.shape, op, **kwargs)
    if cfg.mpc.active_security:
        c = _sacrificed(op, x, y, a, b, c, kwargs)
    if _opens_compressed(op, y):
        # one batched reveal of eps and delta: eps's round and bytes are
        # counted here, delta's bytes with them
        epsilon = comm.all_sum(x.share - a.share)
        delta = y.open(b.share)
        comm.register_virtual("all_sum", delta.numel() * delta.element_size(), rounds=0)
    else:
        epsilon, delta = comm.all_sum([x.share - a.share, y.share - b.share])
    if op == "mul":
        nd = len(torch.broadcast_shapes(x.shape, y.shape))
        z = c.share + epsilon * lift(b.share, nd) + lift(x.share, nd) * delta
        return ArithmeticSharedTensor(z, x.encoder)
    # both products in one ring-mm launch (one accumulator, one write)
    pairs, back = _product_pairs(op, x.ndim, y.ndim, [(epsilon, b.share), (x.share, delta)])
    return ArithmeticSharedTensor(c.share + back(_ring_sum(op, pairs, kwargs)), x.encoder)


_RING_OPS = {
    "mul": lambda a, b: a * b,
    "matmul": ring.matmul,
    "conv1d": ring.conv1d,
    "conv2d": ring.conv2d,
    "conv_transpose1d": ring.conv_transpose1d,
    "conv_transpose2d": ring.conv_transpose2d,
}


class MaskedArithmetic(ArithmeticSharedTensor):
    """A secret operand y pre-masked for Beaver-triple reuse
    (beaver.py:106-173).

    ``b_plain`` is the dealer's draw b (no party axis: only party 0's copy
    enters a share sum, as with every TFP plaintext), ``b_share`` its
    (P, ...) sharing and ``delta = y - b`` the public value revealed once.
    Masking once is simulatable like one Beaver product (delta is padded by
    b), and each later product reveals only a fresh eps = x - a. ``share``
    is an ordinary sharing of y, b_share plus delta on party 0, so every op
    but a product reads the operand as before; ``t``, ``transpose`` and the
    scale-1 view (``_raw``) keep it masked."""

    # ``share`` is a property here: the parent's slot of that name stays unset
    __slots__ = ("b_plain", "b_share", "delta")

    def __init__(self, b_plain, b_share, delta, encoder):
        self.b_plain = b_plain
        self.b_share = b_share
        self.delta = delta
        self.encoder = encoder

    @property
    def share(self):
        return self.b_share + rank0(self.delta, ndim=self.delta.dim())

    @property
    def shape(self):
        return tuple(self.b_plain.shape)

    @property
    def ndim(self):
        return self.b_plain.dim()

    def t(self):
        return self if self.ndim < 2 else self.transpose(-2, -1)

    def transpose(self, d0, d1):
        sd0, sd1 = (d + 1 if d >= 0 else d for d in (d0, d1))
        return MaskedArithmetic(self.b_plain.transpose(d0, d1), self.b_share.transpose(sd0, sd1),
                                self.delta.transpose(d0, d1), self.encoder)

    def with_share(self, share) -> ArithmeticSharedTensor:
        return ArithmeticSharedTensor(share, self.encoder)


def mask_operand(y: ArithmeticSharedTensor):
    """``y`` Beaver-masked for reuse (beaver.py:176-193): b drawn by the
    dealer and shared in one launch, then delta = y - b revealed (one
    round of y's size). Declined, ``y`` returned as it is, where the JAX
    package declines: a dealer other than TFP, active security, and the
    tuple-cache flows, recording and serving alike (the positional tuple
    stream has no mask of its own, and the gate must agree between the run
    that records the requests and the run that is served them)."""
    provider = _provider()
    if (getattr(provider, "NAME", None) != "TFP" or provider.tracing
            or provider.current_cache() is not None or cfg.mpc.active_security):
        return y
    shape = y.shape
    draw_b, share_b = rng.reserve_counts(2)
    ((out, b),) = rng.launch([rng.segment_fresh(shape, 64, draw_b, share_b, emit=True)])
    b_share = rng.shares(out, shape)
    delta = comm.all_sum(y.share - b_share)
    return MaskedArithmetic(b.reshape(shape), b_share, delta, y.encoder)


def _masked_protocol(op, x, y: MaskedArithmetic, **kwargs):
    """One product against a pre-masked y (beaver.py:196-221): the dealer
    draws only an input-sized a. Draws in the JAX package's order: a, its
    sharing, then the output's sharing (a zero sharing for a matmul or a
    convolution, the sharing of c = op(a, b) otherwise)."""
    draw_a, share_a, share_c = rng.reserve_counts(3)
    if op != "mul":
        # the product's shape, from a run on shapes alone (the meta device)
        out_shape = _RING_OPS[op](torch.empty(x.shape, dtype=torch.int64, device="meta"),
                                  torch.empty(y.shape, dtype=torch.int64, device="meta"),
                                  **kwargs).shape
        (a_out, a), c_out = rng.launch([
            rng.segment_fresh(x.shape, 64, draw_a, share_a, emit=True),
            rng.segment_zero(out_shape, share_c)])
        a = a.reshape(x.shape)
        epsilon = comm.all_sum(x.share - rng.shares(a_out, x.shape))
        # the dealer product op(a, b) (party 0's: op(rank0(a), b) =
        # rank0(op(a, b))), op(eps, b) and op(x, delta) in one ring-mm
        # launch of three pairs, at any K: the JAX package sums three
        # products where 3 K >= 2^17 (ring.py:319); the two sums are equal
        # mod 2^64
        pairs, back = _product_pairs(op, x.ndim, y.ndim, [
            (rank0(a, ndim=x.ndim), y.b_plain), (epsilon, y.b_share), (x.share, y.delta)])
        z = rng.shares(c_out, out_shape) + back(_ring_sum(op, pairs, kwargs))
        return ArithmeticSharedTensor(z, x.encoder)
    ((a_out, a),) = rng.launch([rng.segment_fresh(x.shape, 64, draw_a, share_a, emit=True)])
    c = _RING_OPS[op](a.reshape(x.shape), y.b_plain)
    (c_out,) = rng.launch([rng.segment_share(c, share_c)])
    epsilon = comm.all_sum(x.share - rng.shares(a_out, x.shape))
    nd = c.dim()
    z = rng.shares(c_out, c.shape) + epsilon * lift(y.b_share, nd) + lift(x.share, nd) * y.delta
    return ArithmeticSharedTensor(z, x.encoder)


def mul(x, y):
    if isinstance(y, MaskedArithmetic):
        return _masked_protocol("mul", x, y)
    return _beaver_protocol("mul", x, y)


def matmul(x, y):
    if isinstance(y, MaskedArithmetic):
        return _masked_protocol("matmul", x, y)
    return _beaver_protocol("matmul", x, y)


def _conv(op):
    def conv(x, y, **kwargs):
        if isinstance(y, MaskedArithmetic):
            return _masked_protocol(op, x, y, **kwargs)
        return _beaver_protocol(op, x, y, **kwargs)

    conv.__name__ = op
    conv.__doc__ = f"Private {op} (beaver.py:236-254): one Beaver triple, one batched reveal."
    return conv


conv1d = _conv("conv1d")
conv2d = _conv("conv2d")
conv_transpose1d = _conv("conv_transpose1d")
conv_transpose2d = _conv("conv_transpose2d")


def square(x):
    """z = r2 + 2*eps*r + eps^2, one reveal (beaver.py:114-127)."""
    r, r2 = _provider().square(x.shape)
    epsilon = comm.all_sum(x.share - r.share)
    z = r2.share + 2 * r.share * epsilon + rank0(epsilon * epsilon)
    return ArithmeticSharedTensor(z, x.encoder)


def wraps(x):
    """Wrap-count protocol (beaver.py:273): [theta_x] = theta_z +
    [beta_xr] - [theta_r] (the eta term dropped whp)."""
    r, theta_r = _provider().wrap_rng(x.shape)
    beta_xr = ring.count_wraps(torch.stack([x.share, r.share]))
    theta_z = ring.count_wraps(comm.all_gather(x.share + r.share))
    return ArithmeticSharedTensor(beta_xr - theta_r.share + rank0(theta_z), FixedPointEncoder(0))


def truncate(x, y: int):
    """Public-divisor truncation with wrap correction for more than two
    parties (beaver.py:292)."""
    wrap_count = wraps(x)
    share = ring.trunc_div_signed(x.share, y)
    correction = wrap_count.share * ring.scalar(4 * ((1 << 62) // y))
    return ArithmeticSharedTensor(share - correction, x.encoder)


def egk_trunc_pr(x, l: int, m: int):
    """EGK+20 Fig. 10 probabilistic truncation, one reveal (beaver.py:301)."""
    k = 64
    r, r_p, b = _provider().egk_trunc_pr_rng(x.shape, l, m)
    two_to_l = ring.scalar(1 << l)

    # Step 1: mask and reveal c
    a_p = x.share + rank0(ring.scalar(1 << (l - 1)), x.shape)
    rpp = ring.scalar(1 << m) * r.share + r_p.share
    enc_c = ring.scalar(1 << (k - l - 1)) * (a_p + two_to_l * b.share + rpp)
    c = comm.all_sum(enc_c)
    c_p = ring.shift_right_arith(c, k - l - 1)

    # Step 2: strip the masking bit: v = b + c_pl - 2 b c_pl (c_pl public)
    c_pl = ring.shift_right_arith(c_p, l) & 1
    v = b.share + rank0(c_pl) - 2 * b.share * c_pl

    # Step 3: reconstruct the truncation
    c_p_mod = torch.remainder(c_p, two_to_l)
    pub_tail = ring.signed_floordiv_pow2(c_p_mod, m)
    y_share = (
        ring.scalar(1 << (l - m)) * v
        - r.share
        - rank0(ring.scalar(1 << (l - m - 1)), x.shape)
        + rank0(pub_tail)
    )
    return ArithmeticSharedTensor(y_share, x.encoder)


# ---------------------------------------------------------------------------
# LUT protocols — Curl's signature primitives
# ---------------------------------------------------------------------------

def _onehot_fast_available() -> bool:
    """The gate of the direct rotated one-hot (beaver.py:362): the TFP
    dealer's trust, Beaver, passive security, 2 parties, and
    ``mpc.fused_onehot`` not False (False forces the tuple form). Not gated
    on the tuple cache: the form asks the provider for nothing, so it
    engages alike in a recording run and in the run served."""
    if getattr(cfg.mpc, "fused_onehot", True) is False:
        return False
    if cfg.mpc.active_security or cfg.mpc.protocol != "beaver":
        return False
    return _provider().NAME == "TFP" and comm.get_world_size() == 2


def _lut_fastpath_available() -> bool:
    """The gate of the gather-form LUT tuple (beaver.py:423): a provider
    with ``generate_lut_masks`` (TFP) and ``mpc.lut_fastpath`` on; off, the
    one-hot-dot form."""
    return bool(getattr(cfg.mpc, "lut_fastpath", True)) and hasattr(
        _provider(), "generate_lut_masks")


def _lut_chunk_elements() -> int:
    """The bound on an (N, L) one-hot's elements above which the TFP form
    runs in chunks of elements (beaver.py:461): ``mpc.lut_chunk_elements``,
    2^31 where unset."""
    try:
        return int(cfg.mpc.lut_chunk_elements)
    except (AttributeError, TypeError):
        return 1 << 31


def _lut_open_shift(x_flat, size: int):
    """The one-hot tuple of r and the revealed shift (x - r) mod size: one
    round (beaver.py:353)."""
    r, one_hot_r = _provider().generate_one_hot(x_flat.shape, size)
    z = comm.all_sum(x_flat.share - r.share)
    return one_hot_r, torch.remainder(z, size)


def _rotated_table(lut, shift, size: int):
    """The public table at (j + shift_n) mod size: (N, size)."""
    j = torch.arange(size, dtype=torch.int64, device=shift.device)
    return lut[torch.remainder(j[None, :] + shift[:, None], size)]


def _chunked_lut_sum(x_flat, luts_rows, size: int):
    """sum_j onehot_r[n, j] T[(j + shift_n) mod L] for each public table row
    T (beaver.py:474-543): the one-hot tuple and one reveal of the shift.
    The TFP dealer's one-hot is PRZS plus party 0's one-hot of r, which a
    party makes chunk by chunk of elements where N L exceeds
    ``mpc.lut_chunk_elements``, so that no (chunk, L) intermediate is
    larger; a dealer whose sharing communicates (TTP), a cache flow
    (recording or served: the tuple stream must match) and one element
    take the tuple whole."""
    n = x_flat.shape[0]
    limit = _lut_chunk_elements()
    provider = _provider()
    if (provider.NAME != "TFP" or provider.tracing or provider.current_cache() is not None
            or n * size <= limit or n < 2):
        one_hot_r, shift = _lut_open_shift(x_flat, size)
        return [(one_hot_r.share * _rotated_table(row, shift, size)).sum(-1)
                for row in luts_rows]
    # r drawn as generate_one_hot draws it, its sharing, one reveal
    r = rng.random_ring((n,), rng.dealer_stream())
    r_clear = torch.remainder(r, size)
    z = comm.all_sum(x_flat.share - rng.przs_share(r_clear))
    shift = torch.remainder(z, size)
    chunk = max(limit // size, 1)
    grid = torch.arange(size, dtype=torch.int64, device=r.device)
    outs = [[] for _ in luts_rows]
    for lo in range(0, n, chunk):
        rc, sh = r_clear[lo:lo + chunk], shift[lo:lo + chunk]
        oh_share = rng.przs_share((rc[:, None] == grid).to(torch.int64))
        for out, row in zip(outs, luts_rows):
            out.append((oh_share * _rotated_table(row, sh, size)).sum(-1))
    return [torch.cat(out, dim=-1) for out in outs]


def _rotated_onehot_fast(x_flat, size: int):
    """Share of onehot(x mod size), built as fresh PRZS plus party 0's
    one-hot of (r + shift) mod size = x (beaver.py:388-420): one revealed
    value z = x - r, the same rounds and share distribution as the
    reference's tuple one-hot, without the (N, size) rotation."""
    r = rng.random_ring(x_flat.shape, rng.dealer_stream())
    r_clear = torch.remainder(r, size)
    r_share = rng.przs_share(r_clear)
    z = comm.all_sum(x_flat.share - r_share)
    x_idx = torch.remainder(r_clear + torch.remainder(z, size), size)
    grid = torch.arange(size, dtype=torch.int64, device=x_idx.device)
    onehot = (x_idx[:, None] == grid[None, :]).to(torch.int64)
    return rng.przs_share(onehot)


def _rotated_onehot(x_flat, size: int):
    """Share of onehot(x mod size): the direct form under its gate, else the
    one-hot tuple rotated by the revealed shift (beaver.py:613-620)."""
    if _onehot_fast_available():
        return _rotated_onehot_fast(x_flat, size)
    one_hot_r, shift = _lut_open_shift(x_flat, size)
    j = torch.arange(size, dtype=torch.int64, device=shift.device)
    idx = torch.remainder(j[None, :] - shift[:, None], size)
    share = one_hot_r.share
    return torch.gather(share, -1, idx.expand(share.shape))


def _lut_gather_fast(x_flat, luts_rows, size: int):
    """[T[x mod L] for T in luts_rows] in gather form: output-shaped PRZS
    masks plus, on party 0 only, the public table at (r + shift) mod L."""
    r_clear, r_share, masks = _provider().generate_lut_masks(
        x_flat.shape, size, len(luts_rows)
    )
    z = comm.all_sum(x_flat.share - r_share.share)
    idx = torch.remainder(r_clear + torch.remainder(z, size), size)
    return [masks[i] + rank0(row[idx]) for i, row in enumerate(luts_rows)]


def _lut_rows(x_flat, luts_rows, size: int):
    """The tables' rows at x mod size: the gather form under its gate, else
    the one-hot-dot form."""
    if _lut_fastpath_available():
        return _lut_gather_fast(x_flat, luts_rows, size)
    return _chunked_lut_sum(x_flat, luts_rows, size)


def _flat(x):
    return x.with_share(x.share.reshape(x.share.shape[0], -1))


def evaluate_lut(x, lut):
    """result[n] = T[x_n mod L] with one reveal (beaver.py:552)."""
    lut = ring.constant(lut, comm.get_device())
    (result,) = _lut_rows(_flat(x), [lut], lut.shape[0])
    return ArithmeticSharedTensor(result.reshape(x.share.shape), x.encoder)


def evaluate_bior_lut(x, luts, scale, bias: int):
    """Two-bank LUT + private linear interpolation (beaver.py:566):
    (lut1 - lut0) * scale + 2^bias * lut0, then EGK-truncate by 2*bias."""
    luts = ring.constant(luts, comm.get_device())  # (2, L)
    lut0, lut1 = _lut_rows(_flat(x), [luts[0], luts[1]], luts.shape[1])
    scaling = _raw(_flat(scale))
    prod = mul(ArithmeticSharedTensor(lut1 - lut0, FixedPointEncoder(0)), scaling)
    combined = prod.share + ring.scalar(1 << bias) * lut0
    out = egk_trunc_pr(ArithmeticSharedTensor(combined, FixedPointEncoder(0)), 62, 2 * bias)
    return ArithmeticSharedTensor(out.share.reshape(x.share.shape), x.encoder)


def _embed_matmul(onehot, table):
    """The rotated one-hot times a secret table: a Beaver-masked table's
    reused mask, else the protocol's matmul (a replicated product under
    ``mpc.protocol: replicated``)."""
    from .arithmetic import _get_protocol

    x = ArithmeticSharedTensor(onehot, FixedPointEncoder(0))
    if isinstance(table, MaskedArithmetic):
        return _masked_protocol("matmul", x, table)
    return _get_protocol().matmul(x, table)


def evaluate_embed(x, embed):
    """Private embedding lookup: the secret one-hot of x times the secret
    table, one private matmul (beaver.py:590); against a Beaver-masked table
    (``MaskedArithmetic``) the product reuses its mask."""
    size, dim = embed.shape
    rotated = _rotated_onehot(_flat(x), size)
    lookup = _embed_matmul(rotated, _raw(embed))
    out_shape = x.share.shape + (dim,)
    return ArithmeticSharedTensor(lookup.share.reshape(out_shape), FixedPointEncoder(0))


def evaluate_embed_chunked(x, table_chunks, v_real: int, dim: int):
    """Private embedding lookup against a vocab-sliced secret table
    (beaver.py:635). The lookup factorizes over vocab slices,

        onehot @ T = sum_i onehot[:, i*Vc:(i+1)*Vc] @ T_i,

    so the rotated one-hot is built once over the padded vocabulary
    n * Vc (one reveal), then each chunk runs one private matmul and the
    shares accumulate. ``table_chunks``: n (Vc, dim) shared tensors (plain
    or seed-compressed), whose vocab padding rows are zero. The JAX
    package's scan is a loop here; every chunk's draws take fresh counts."""
    vc = table_chunks[0].shape[0]
    v_pad = len(table_chunks) * vc
    if v_real > v_pad:
        raise ValueError(f"vocabulary {v_real} exceeds the {len(table_chunks)} chunks of {vc}")
    rotated = _rotated_onehot(_flat(x), v_pad)
    acc = None
    for i, t_i in enumerate(table_chunks):
        part = _embed_matmul(rotated[:, :, i * vc:(i + 1) * vc], _raw(t_i)).share
        acc = part if acc is None else acc + part
    return ArithmeticSharedTensor(acc.reshape(x.share.shape + (dim,)), FixedPointEncoder(0))


# ---------------------------------------------------------------------------
# Binary Beaver + share conversion helpers
# ---------------------------------------------------------------------------

def AND(x, y):
    """Binary Beaver protocol, one batched reveal (beaver.py:699)."""
    from .binary import BinarySharedTensor

    shape = torch.broadcast_shapes(x.shape, y.shape)
    full = (x.share.shape[0],) + tuple(shape)
    xs = lift(x.share, len(shape)).expand(full)
    ys = lift(y.share, len(shape)).expand(full)
    a, b, c = _provider().generate_binary_triple(shape, shape)
    epsilon, delta = comm.all_xor([xs ^ a.share, ys ^ b.share])
    # z = c ^ (eps & b) ^ (x & delta): x = a ^ eps, no party-0 term
    z = (b.share & epsilon) ^ (xs & delta) ^ c.share
    return BinarySharedTensor(z, x.encoder)


def B2A_single_bit(xB):
    """Convert single-bit binary shares to arithmetic (beaver.py:715)."""
    if comm.get_world_size() < 2:
        return ArithmeticSharedTensor(xB.share, FixedPointEncoder(0))
    rA, rB = _provider().B2A_rng(xB.shape)
    z = comm.all_xor(xB.share ^ rB.share)
    # rA * (1 - 2z) + z with z public
    share = rA.share * (1 - 2 * z) + rank0(z)
    return ArithmeticSharedTensor(share, FixedPointEncoder(0))
