from ..config import cfg
from .provider import get_provider
from .ptype import ptype  # noqa: F401

_default_provider = None
_default_provider_name = None


def get_default_provider():
    """Provider singleton selected by cfg.mpc.provider."""
    global _default_provider, _default_provider_name
    name = cfg.mpc.provider
    if _default_provider is None or _default_provider_name != name:
        _default_provider = get_provider(name)
        _default_provider_name = name
    return _default_provider


from .mpc import MPCTensor  # noqa: E402,F401
