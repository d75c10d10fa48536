"""Share-type enum (counterpart of ``curl_tpu/mpc/ptype.py``)."""

from enum import Enum


class ptype(Enum):
    arithmetic = 0
    binary = 1
