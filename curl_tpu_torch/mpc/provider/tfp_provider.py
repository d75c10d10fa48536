"""Trusted First Party provider: insecure dev dealer (party 0 knows tuples).

Counterpart of ``curl_tpu/mpc/provider/tfp_provider.py``. Every tuple
plaintext is drawn once from the dealer stream, without a party axis (the
JAX package draws it once per program under the simulated-party runtime),
and shared by PRZS with party 0 adding the plaintext: one Philox ``share``
launch per tuple component.
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


def _bshare_from_local(value) -> BinarySharedTensor:
    share = rng.przs_binary(tuple(value.shape))
    share = share ^ (value * comm.rank_mask(0, value.dim()))
    return BinarySharedTensor.from_shares(share)


def _ring_op(op):
    from ..primitives.beaver import _RING_OPS

    return _RING_OPS[op]


class TrustedFirstParty(TupleProvider):
    NAME = "TFP"

    def generate_additive_triple(self, size0, size1, op):
        """Beaver triple (a, b, c = op(a, b)); c is one dealer product."""
        a = rng.random_ring(size0, rng.dealer_stream())
        b = rng.random_ring(size1, rng.dealer_stream())
        c = _ring_op(op)(a, b)
        return _share_from_local(a), _share_from_local(b), _share_from_local(c)

    def square(self, size):
        r = rng.random_ring(size, rng.dealer_stream())
        return _share_from_local(r), _share_from_local(r * r)

    def generate_binary_triple(self, size0, size1):
        a = rng.random_kbit(size0, 64, rng.dealer_stream())
        b = rng.random_kbit(size1, 64, rng.dealer_stream())
        c = a & b
        shape = torch.broadcast_shapes(tuple(size0), tuple(size1))
        return tuple(_bshare_from_local(v.expand(shape)) for v in (a, b, c))

    def wrap_rng(self, size):
        """Random share planes and a sharing of their wrap count: the dealer
        draws all P planes, counts their wraps and scatters plane p to
        party p (tfp_provider.py:80)."""
        planes = torch.stack(
            [rng.random_ring(size, rng.dealer_stream()) for _ in range(comm.get_world_size())]
        )
        theta_r = ring.count_wraps(planes)
        r = ArithmeticSharedTensor.from_shares(comm.scatter(planes, src=0), precision=0)
        return r, _share_from_local(theta_r)

    def B2A_rng(self, size):
        r = rng.random_kbit(size, 1, rng.dealer_stream())
        return _share_from_local(r), _bshare_from_local(r)

    def generate_lut_masks(self, tensor_size, lut_size: int, n_tables: int):
        """Gather-form one-hot tuple: (r_clear, [r], output PRZS masks); see
        the JAX package's generate_lut_masks for the algebra."""
        r = rng.random_ring(tensor_size, rng.dealer_stream())
        r_clear = torch.remainder(r, lut_size)
        r_shares = _share_from_local(r_clear)
        masks = [rng.przs_arithmetic(tuple(tensor_size)) for _ in range(n_tables)]
        return r_clear, r_shares, masks

    def egk_trunc_pr_rng(self, size, l: int, m: int):
        """(r, r', b) randomness for EGK truncation."""
        r = rng.random_kbit(size, l - m, rng.dealer_stream())
        r_p = rng.random_kbit(size, m, rng.dealer_stream())
        b = rng.random_kbit(size, 1, rng.dealer_stream())
        return _share_from_local(r), _share_from_local(r_p), _share_from_local(b)

