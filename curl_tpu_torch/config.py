"""Config system: YAML-backed dot-notation singleton with temp_override.

Counterpart of ``curl_tpu/config.py``: a module-level ``cfg`` singleton,
attribute and dot-path access, ``cfg.set`` and ``cfg.temp_override({...})``,
loaded from the package's own ``configs/default.yaml`` (same keys and values
as the JAX package's profile).
"""

from __future__ import annotations

import contextlib
import copy
import os
from typing import Any, Dict

import yaml

_DEFAULT_CONFIG = os.path.join(os.path.dirname(__file__), "configs", "default.yaml")


class _Node:
    """Attribute-accessible nested dict."""

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, "_data", {})
        for k, v in data.items():
            self._data[k] = _Node(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_data")[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self._data[name] = _Node(value) if isinstance(value, dict) else value

    def __contains__(self, name):
        return name in self._data

    def to_dict(self):
        return {
            k: v.to_dict() if isinstance(v, _Node) else v for k, v in self._data.items()
        }


class CurlConfig:
    """Configuration singleton; loads YAML and exposes dot access."""

    def __init__(self):
        with open(_DEFAULT_CONFIG) as f:
            self.config = _Node(yaml.safe_load(f))

    def __getattr__(self, name):
        # only reached for names that are not attributes of the wrapper
        return getattr(self.config, name)

    def get(self, keys: str):
        node = self.config
        for k in keys.split("."):
            node = getattr(node, k)
        return node

    def set(self, keys: str, value):
        parts = keys.split(".")
        node = self.config
        for k in parts[:-1]:
            if k not in node:
                setattr(node, k, {})
            node = getattr(node, k)
        setattr(node, parts[-1], value)

    @contextlib.contextmanager
    def temp_override(self, override_dict: Dict[str, Any]):
        """Temporarily override dot-path keys; restores the whole config."""
        old = copy.deepcopy(self.config)
        try:
            for k, v in override_dict.items():
                self.set(k, v)
            yield
        finally:
            self.config = old

    def to_dict(self):
        return self.config.to_dict()


cfg = CurlConfig()
