from .baseOT import BaseOT  # noqa: F401
