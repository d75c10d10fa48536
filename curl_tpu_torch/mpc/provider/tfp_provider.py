"""Trusted First Party provider: insecure dev dealer (party 0 knows tuples).

Counterpart of ``curl_tpu/mpc/provider/tfp_provider.py``. Every tuple
plaintext is drawn once from the dealer stream, without a party axis (the
JAX package draws it once per program under the simulated-party runtime),
and shared by PRZS with party 0 adding (or XORing) the plaintext. A call
reserves its draw counters in order (draws first, then shares), then hands
its draws and shares to one grouped Philox launch, or two where a dealer
product (``c = op(a, b)``, ``r * r``, ``a & b``, ``r mod L``) stands between
the draw and its sharing: a fresh segment draws and shares a plaintext in
one pass.
"""

from __future__ import annotations

import torch

from ... import comm
from ... import random as rng
from ... import ring
from ..primitives.arithmetic import ArithmeticSharedTensor
from ..primitives.binary import BinarySharedTensor
from .provider import TupleProvider


def _share_from_local(value, precision: int = 0) -> ArithmeticSharedTensor:
    return ArithmeticSharedTensor.from_shares(rng.przs_share(value), precision=precision)


def _arith(out, shape) -> ArithmeticSharedTensor:
    return ArithmeticSharedTensor.from_shares(rng.shares(out, shape), precision=0)


def _ring_op(op):
    from ..primitives.beaver import _RING_OPS

    return _RING_OPS[op]


class TrustedFirstParty(TupleProvider):
    NAME = "TFP"

    def generate_additive_triple(self, size0, size1, op, **kwargs):
        """Beaver triple (a, b, c = op(a, b)); c is one dealer product (a
        convolution's under its keyword arguments, through the ring's
        im2col product). Two launches: a and b drawn and shared, then c
        shared."""
        draw_a, draw_b, share_a, share_b, share_c = rng.reserve_counts(5)
        (da, a), (db, b) = rng.launch([
            rng.segment_fresh(size0, 64, draw_a, share_a, emit=True),
            rng.segment_fresh(size1, 64, draw_b, share_b, emit=True)])
        c = _ring_op(op)(a.reshape(tuple(size0)), b.reshape(tuple(size1)), **kwargs)
        (dc,) = rng.launch([rng.segment_share(c, share_c)])
        return _arith(da, size0), _arith(db, size1), _arith(dc, c.shape)

    def square(self, size):
        draw_r, share_r, share_r2 = rng.reserve_counts(3)
        ((dr, r),) = rng.launch([rng.segment_fresh(size, 64, draw_r, share_r, emit=True)])
        r = r.reshape(tuple(size))
        (dr2,) = rng.launch([rng.segment_share(r * r, share_r2)])
        return _arith(dr, size), _arith(dr2, r.shape)

    def generate_binary_triple(self, size0, size1):
        """a, b and c = a & b XOR-shared at the broadcast shape: two
        launches, the draws, then the three sharings."""
        draw_a, draw_b, *share = rng.reserve_counts(5)
        da, db = rng.launch([rng.segment_draw(size0, 64, rng.dealer_stream(), draw_a),
                             rng.segment_draw(size1, 64, rng.dealer_stream(), draw_b)])
        a, b = da[0].reshape(tuple(size0)), db[0].reshape(tuple(size1))
        shape = torch.broadcast_shapes(tuple(size0), tuple(size1))
        outs = rng.launch([rng.segment_share(v.expand(shape), count, how="xor")
                           for v, count in zip((a, b, a & b), share)])
        return tuple(BinarySharedTensor.from_shares(rng.shares(out, shape)) for out in outs)

    def wrap_rng(self, size):
        """Random share planes and a sharing of their wrap count: the dealer
        draws all P planes, counts their wraps and scatters plane p to
        party p (tfp_provider.py:80)."""
        counts = rng.reserve_counts(comm.get_world_size())
        planes = torch.stack([out[0].reshape(tuple(size)) for out in rng.launch(
            [rng.segment_draw(size, 64, rng.dealer_stream(), c) for c in counts])])
        theta_r = ring.count_wraps(planes)
        r = ArithmeticSharedTensor.from_shares(comm.scatter(planes, src=0), precision=0)
        return r, _share_from_local(theta_r)

    def B2A_rng(self, size):
        """One 1-bit dealer draw, shared additively and by XOR in one launch
        (the XOR sharing's streams are 64-bit, as przs_binary's)."""
        draw_r, share_a, share_b = rng.reserve_counts(3)
        da, db = rng.launch([rng.segment_fresh(size, 1, draw_r, share_a),
                             rng.segment_fresh(size, 1, draw_r, share_b, how="xor")])
        return _arith(da, size), BinarySharedTensor.from_shares(rng.shares(db, size))

    def generate_one_hot(self, tensor_size, lut_size: int):
        """r mod L and its one-hot row per element (tfp_provider.py:96): r
        drawn, then r mod L and the (..., L) one-hot shared in one launch."""
        draw_r, share_r, share_oh = rng.reserve_counts(3)
        (dr,) = rng.launch([rng.segment_draw(tensor_size, 64, rng.dealer_stream(), draw_r)])
        r_clear = torch.remainder(dr[0].reshape(tuple(tensor_size)), lut_size)
        grid = torch.arange(lut_size, dtype=torch.int64, device=r_clear.device)
        one_hot = (r_clear[..., None] == grid).to(torch.int64)
        d_r, d_oh = rng.launch([rng.segment_share(r_clear, share_r),
                                rng.segment_share(one_hot, share_oh)])
        return _arith(d_r, tensor_size), _arith(d_oh, one_hot.shape)

    def generate_lut_masks(self, tensor_size, lut_size: int, n_tables: int):
        """Gather-form one-hot tuple: (r_clear, [r], output PRZS masks); see
        the JAX package's generate_lut_masks for the algebra. Two launches:
        r drawn, then r mod L shared beside the masks."""
        draw_r, share_r, *masks = rng.reserve_counts(2 + n_tables)
        (dr,) = rng.launch([rng.segment_draw(tensor_size, 64, rng.dealer_stream(), draw_r)])
        r_clear = torch.remainder(dr[0].reshape(tuple(tensor_size)), lut_size)
        outs = rng.launch([rng.segment_share(r_clear, share_r)]
                          + [rng.segment_zero(tensor_size, c) for c in masks])
        return (r_clear, _arith(outs[0], tensor_size),
                [rng.shares(out, tensor_size) for out in outs[1:]])

    def egk_trunc_pr_rng(self, size, l: int, m: int):
        """(r, r', b) randomness for EGK truncation: three dealer draws of
        l - m, m and 1 bits, drawn and shared in one launch."""
        counts = rng.reserve_counts(6)
        outs = rng.launch([rng.segment_fresh(size, bits, counts[i], counts[3 + i])
                           for i, bits in enumerate((l - m, m, 1))])
        return tuple(_arith(out, size) for out in outs)
