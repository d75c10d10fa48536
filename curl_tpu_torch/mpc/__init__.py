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


def set_default_provider(name: str):
    """Select the provider by name (curl_tpu/mpc/__init__.py): TFP, TTP or
    HE."""
    cfg.set("mpc.provider", name)
    get_default_provider()


def ttp_required() -> bool:
    """True when the configured provider needs the TTP dealer streams."""
    return cfg.mpc.provider == "TTP"


from .mpc import MPCTensor  # noqa: E402,F401
