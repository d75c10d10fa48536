"""Tuple-provider base (counterpart of ``curl_tpu/mpc/provider/provider.py``).

The JAX package's base class also records tuple requests and serves them
from an offline cache; that flow is a later slice of the port. This slice
needs the provider identity only.
"""

from __future__ import annotations


class TupleProvider:
    """Base provider: subclasses generate correlated tuples on demand."""

    NAME: str = "base"


def get_provider(name: str) -> TupleProvider:
    if name != "TFP":
        raise NotImplementedError(f"provider {name!r} is not ported yet (TFP only)")
    from .tfp_provider import TrustedFirstParty

    return TrustedFirstParty()
