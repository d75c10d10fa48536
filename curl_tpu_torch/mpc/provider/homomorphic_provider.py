"""Homomorphic-encryption provider: a stub that raises, as the JAX package's
(``curl_tpu/mpc/provider/homomorphic_provider.py``) and the reference's
(``curl/mpc/provider/homomorphic_provider.py:11``) do."""

from .provider import TupleProvider


def _missing(*args, **kwargs):
    raise NotImplementedError("HE provider not implemented")


class HomomorphicProvider(TupleProvider):
    NAME = "HE"

    generate_additive_triple = staticmethod(_missing)
    square = staticmethod(_missing)
    generate_binary_triple = staticmethod(_missing)
    wrap_rng = staticmethod(_missing)
    B2A_rng = staticmethod(_missing)
    generate_one_hot = staticmethod(_missing)
    egk_trunc_pr_rng = staticmethod(_missing)
