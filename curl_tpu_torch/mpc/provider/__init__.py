from .provider import TupleProvider, get_provider  # noqa: F401
