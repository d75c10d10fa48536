"""Trusted Third Party provider: the dealer shares every tuple with each party.

Counterpart of ``curl_tpu/mpc/provider/ttp_provider.py`` (the reference's
``curl/mpc/provider/ttp_provider.py:25-430``). Each party p >= 1 shares a
``ttp`` stream with the dealer and draws its tuple shares from it; the
dealer, which draws the tuple plaintexts from its own ``dealer`` stream,
computes party 0's share as the plaintext minus (or XOR) the others' and
sends it: one message of the share's size, which the JAX package counts
as one ``all_sum`` (``all_xor`` for a binary share) and the port counts the
same (``comm.register_virtual``), as it computes party 0's share in the
sharing pass itself.

A call hands its draws and sharings to one grouped Philox launch, or two
where a dealer product stands between (``c = op(a, b)``, ``r * r``, ``a &
b``, the wrap count, the one-hot): a ``ttp_fresh`` segment draws a
plaintext and shares it in one pass, a ``ttp_plain`` segment shares a given
one (``kernels/philox.py``). TTP has no gather-form LUT tuple
(``generate_lut_masks``): its LUTs take the one-hot-dot form.
"""

from __future__ import annotations

import torch

from ... import comm
from ... import random as rng
from ... import ring
from ..primitives.arithmetic import ArithmeticSharedTensor
from ..primitives.binary import BinarySharedTensor
from .provider import TupleProvider


def _sent(out, how: str = "add"):
    """Count the dealer's message to party 0: one round of one party's
    share, as the JAX package's masked all_sum (all_xor) counts it."""
    if comm.get_world_size() >= 2:
        comm.register_virtual("all_sum" if how == "add" else "all_xor", out[0].numel() * 8)
    return out


def _arith(out, shape) -> ArithmeticSharedTensor:
    return ArithmeticSharedTensor.from_shares(rng.shares(_sent(out), tuple(shape)), precision=0)


def _binary(out, shape) -> BinarySharedTensor:
    return BinarySharedTensor.from_shares(rng.shares(_sent(out, "xor"), tuple(shape)))


def _ring_op(op):
    from ..primitives.beaver import _RING_OPS

    return _RING_OPS[op]


class TrustedThirdParty(TupleProvider):
    NAME = "TTP"

    def generate_additive_triple(self, size0, size1, op, **kwargs):
        """Beaver triple (a, b, c = op(a, b)): a and b drawn and shared in one
        launch, the dealer product, then c shared."""
        draw_a, draw_b, share_a, share_b, share_c = rng.reserve_counts(5)
        (da, a), (db, b) = rng.launch([
            rng.segment_ttp_fresh(size0, 64, draw_a, share_a, emit=True),
            rng.segment_ttp_fresh(size1, 64, draw_b, share_b, emit=True)])
        c = _ring_op(op)(a.reshape(tuple(size0)), b.reshape(tuple(size1)), **kwargs)
        (dc,) = rng.launch([rng.segment_ttp_share(c, share_c)])
        return _arith(da, size0), _arith(db, size1), _arith(dc, c.shape)

    def square(self, size):
        draw_r, share_r, share_r2 = rng.reserve_counts(3)
        ((dr, r),) = rng.launch([rng.segment_ttp_fresh(size, 64, draw_r, share_r, emit=True)])
        r = r.reshape(tuple(size))
        (dr2,) = rng.launch([rng.segment_ttp_share(r * r, share_r2)])
        return _arith(dr, size), _arith(dr2, r.shape)

    def generate_binary_triple(self, size0, size1):
        """a, b and c = a & b, XOR-shared at the broadcast shape: the draws,
        then the three sharings."""
        draw_a, draw_b, *share = rng.reserve_counts(5)
        da, db = rng.launch([rng.segment_draw(size0, 64, "dealer", draw_a),
                             rng.segment_draw(size1, 64, "dealer", draw_b)])
        a, b = da[0].reshape(tuple(size0)), db[0].reshape(tuple(size1))
        shape = torch.broadcast_shapes(tuple(size0), tuple(size1))
        outs = rng.launch([rng.segment_ttp_share(v.expand(shape), count, how="xor")
                           for v, count in zip((a, b, a & b), share)])
        return tuple(_binary(out, shape) for out in outs)

    def wrap_rng(self, size):
        """Random share planes and a sharing of their wrap count: the dealer
        draws all P planes (plane p is party p's ttp draw in the
        reference), counts their wraps and shares the count."""
        *counts, share = rng.reserve_counts(comm.get_world_size() + 1)
        planes = torch.stack([out[0].reshape(tuple(size)) for out in rng.launch(
            [rng.segment_draw(size, 64, "dealer", c) for c in counts])])
        (dt,) = rng.launch([rng.segment_ttp_share(ring.count_wraps(planes), share)])
        return ArithmeticSharedTensor.from_shares(planes, precision=0), _arith(dt, size)

    def B2A_rng(self, size):
        """One 1-bit dealer draw, shared additively and by XOR in one launch."""
        draw_r, share_a, share_b = rng.reserve_counts(3)
        da, db = rng.launch([rng.segment_ttp_fresh(size, 1, draw_r, share_a),
                             rng.segment_ttp_fresh(size, 1, draw_r, share_b, how="xor")])
        return _arith(da, size), _binary(db, size)

    def generate_one_hot(self, tensor_size, lut_size: int):
        """r mod L and its one-hot row per element (ttp_provider.py:95-104):
        r drawn, then r mod L and the (..., L) one-hot shared in one launch."""
        draw_r, share_r, share_oh = rng.reserve_counts(3)
        (dr,) = rng.launch([rng.segment_draw(tensor_size, 64, "dealer", draw_r)])
        r_clear = torch.remainder(dr[0].reshape(tuple(tensor_size)), lut_size)
        grid = torch.arange(lut_size, dtype=torch.int64, device=r_clear.device)
        one_hot = (r_clear[..., None] == grid).to(torch.int64)
        d_r, d_oh = rng.launch([rng.segment_ttp_share(r_clear, share_r),
                                rng.segment_ttp_share(one_hot, share_oh)])
        return _arith(d_r, tensor_size), _arith(d_oh, one_hot.shape)

    def egk_trunc_pr_rng(self, size, l: int, m: int):
        """(r, r', b) randomness for EGK truncation: three dealer draws of
        l - m, m and 1 bits, drawn and shared in one launch."""
        counts = rng.reserve_counts(6)
        outs = rng.launch([rng.segment_ttp_fresh(size, bits, counts[i], counts[3 + i])
                           for i, bits in enumerate((l - m, m, 1))])
        return tuple(_arith(out, size) for out in outs)
