"""Config system: YAML-backed dot-notation singleton with temp_override.

Counterpart of ``curl_tpu/config.py``: a module-level ``cfg`` singleton,
attribute and dot-path access (``cfg.mpc.provider``, ``cfg["mpc.provider"]``),
``cfg.set``, ``cfg.temp_override({...})``, ``load_config`` (which replaces
the whole config with a profile's, as the JAX package's does) and
``set_config``. The package ships its own profiles in ``configs/``:
``default.yaml``, ``llm_config.yaml`` and ``approximations.yaml``, the same
keys and values as the JAX package's, each knob in the port's spelling. The
last two are partial: code that reads a key they lack falls back to the
default, as the JAX package's does.

``cfg.snapshot()`` is a hashable frozen view of the whole config. Every
change (``set``, a profile loaded, a temp_override entered or left, an
attribute set on a node) bumps a version, and the snapshot is rebuilt only
when the version moved: the lazy scope (``lazy.py``) reads it once an op
to key what it records.
"""

from __future__ import annotations

import contextlib
import copy
import os
from typing import Any, Dict

import yaml

_CONFIGS = os.path.join(os.path.dirname(__file__), "configs")
_DEFAULT_CONFIG = os.path.join(_CONFIGS, "default.yaml")

# bumped by every change to any config node (see snapshot)
_version = [0]


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
        _version[0] += 1

    def __contains__(self, name):
        return name in self._data

    def to_dict(self):
        return {
            k: v.to_dict() if isinstance(v, _Node) else v for k, v in self._data.items()
        }


def _freeze(obj):
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


class CurlConfig:
    """Configuration singleton; loads YAML and exposes dot access."""

    def __init__(self, config_file=None):
        self._snapshot = (None, None)
        self.load_config(config_file)

    @property
    def config(self) -> _Node:
        return self._config

    @config.setter
    def config(self, node: _Node):
        self._config = node
        _version[0] += 1

    def __getattr__(self, name):
        # only reached for names that are not attributes of the wrapper
        return getattr(self.config, name)

    def load_config(self, config_file=None):
        """Replace the whole config with the profile at ``config_file``
        (``configs/default.yaml`` where None)."""
        with open(_DEFAULT_CONFIG if config_file is None else config_file) as f:
            self.config = _Node(yaml.safe_load(f))

    def set_config(self, config):
        """Adopt another CurlConfig's config, or a config node."""
        self.config = config.config if isinstance(config, CurlConfig) else config

    def __getitem__(self, keys: str):
        return self.get(keys)

    def __setitem__(self, keys: str, value):
        self.set(keys, value)

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

    @contextlib.contextmanager
    def restored(self, data: Dict[str, Any]):
        """The config of ``data`` (a ``to_dict()``) for the block, then the
        config as it was."""
        old = self.config
        self.config = _Node(data)
        try:
            yield
        finally:
            self.config = old

    def snapshot(self):
        """Hashable frozen view of the full config (curl_tpu/config.py:119),
        rebuilt only after a change."""
        version, snap = self._snapshot
        if version != _version[0]:
            snap = _freeze(self.config.to_dict())
            self._snapshot = (_version[0], snap)
        return snap

    def to_dict(self):
        return self.config.to_dict()


def profile(name: str) -> str:
    """The path of one of the package's profiles: ``"default"``,
    ``"llm_config"`` or ``"approximations"``."""
    return os.path.join(_CONFIGS, f"{name}.yaml")


cfg = CurlConfig()
