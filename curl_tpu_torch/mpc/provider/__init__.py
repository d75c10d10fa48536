from .provider import TupleProvider, get_provider  # noqa: F401
from .tfp_provider import TrustedFirstParty  # noqa: F401
from .ttp_provider import TrustedThirdParty  # noqa: F401
from .homomorphic_provider import HomomorphicProvider  # noqa: F401
