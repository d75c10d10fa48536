"""Naor-Pinkas 1-out-of-2 oblivious transfer.

The port's own copy of ``curl_tpu/mpc/primitives/ot/baseOT.py`` (the
reference's ``curl/mpc/primitives/ot/baseOT.py:21-154``, used there only by
its test suite and by no protocol). Host-side Python integers: OT is an
interactive point-to-point protocol between two parties, and no part of it
runs on the card.

Protocol (receiver choice bit b, sender messages m0/m1):
  sender:   C  <- random group element, publishes (g, C)
  receiver: k  <- random; PK_b = g^k; PK_{1-b} = C / PK_b; sends PK_0
  sender:   r0, r1 random; e_i = (g^{r_i}, m_i XOR H(PK_i^{r_i}))
  receiver: m_b = e_b[1] XOR H(e_b[0]^k)
"""

from __future__ import annotations

import hashlib
import secrets

# Mersenne prime 2^127 - 1 (same order of magnitude as the reference's
# hardcoded 129-bit group; any large prime group works here)
P = (1 << 127) - 1
G = 3


def _hash_to_bytes(x: int, length: int) -> bytes:
    digest = b""
    counter = 0
    while len(digest) < length:
        digest += hashlib.sha256(
            x.to_bytes(32, "big") + counter.to_bytes(4, "big")
        ).digest()
        counter += 1
    return digest[:length]


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


class BaseOT:
    """Two-endpoint in-process OT (simulation transport).

    For a real deployment the three `transfer` messages ride any authenticated
    channel; the math is transport-agnostic.
    """

    @staticmethod
    def transfer(messages_by_sender, choice_bits_by_receiver):
        """Batch 1-of-2 OT.

        messages_by_sender: list of (m0: bytes, m1: bytes)
        choice_bits_by_receiver: list of 0/1
        returns: list of chosen message bytes (receiver's view)
        """
        out = []
        for (m0, m1), b in zip(messages_by_sender, choice_bits_by_receiver):
            assert len(m0) == len(m1)
            length = len(m0)

            # sender round 1
            c_exp = secrets.randbelow(P - 2) + 1
            C = pow(G, c_exp, P)

            # receiver round: build PK_b with known dlog
            k = secrets.randbelow(P - 2) + 1
            pk_b = pow(G, k, P)
            pk_other = (C * pow(pk_b, P - 2, P)) % P  # C / PK_b
            pk0 = pk_b if b == 0 else pk_other

            # sender round 2
            pk1 = (C * pow(pk0, P - 2, P)) % P
            r0 = secrets.randbelow(P - 2) + 1
            r1 = secrets.randbelow(P - 2) + 1
            e0 = (pow(G, r0, P), _xor(m0, _hash_to_bytes(pow(pk0, r0, P), length)))
            e1 = (pow(G, r1, P), _xor(m1, _hash_to_bytes(pow(pk1, r1, P), length)))

            # receiver decrypt
            gr, cipher = e0 if b == 0 else e1
            msg = _xor(cipher, _hash_to_bytes(pow(gr, k, P), length))
            out.append(msg)
        return out
