"""Optimizers over encrypted parameters (counterpart of ``curl_tpu/optim``)."""

from .optimizer import Optimizer  # noqa: F401
from .sgd import SGD  # noqa: F401
