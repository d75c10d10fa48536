"""Function library: share-structure ops and MPC math, installed on the
tensor classes at import (counterpart of ``curl_tpu/functions``)."""

from . import regular  # noqa: F401  (structure ops, mean/var/prod)
from . import logic  # noqa: F401    (comparisons, sign)
from . import sampling  # noqa: F401  (randn, bernoulli, weighted_index and _sample)
from . import maximum  # noqa: F401  (max, max_value)
from . import power  # noqa: F401  (pow, pos_pow, polynomial, norm)
from . import approximations  # noqa: F401  (LUT nonlinearities)
from . import pooling  # noqa: F401  (max_pool2d, adaptive pooling)
from . import dropout  # noqa: F401
