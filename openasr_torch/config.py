"""Config system: attribute-accessible nested dicts loaded from YAML.

Counterpart of openasr_tpu/config.py with the identical YAML schema
(`data / training / model`, model subsections `signal / encoder / decoder`).
The key-surface validation and MoE checks of the JAX module belong to the
training slice and are not carried yet.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

import yaml


class Config(dict):
    """A dict with attribute access and recursive wrapping.

    Missing attribute access returns ``None`` (configs rely on optional
    keys being falsy when absent).
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__()
        merged: dict = {}
        for a in args:
            if a is None:
                continue
            merged.update(a)
        merged.update(kwargs)
        for k, v in merged.items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            return None

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        """Plain nested dict (for serialization)."""
        out: dict = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = type(v)(
                    x.to_dict() if isinstance(x, Config) else x for x in v
                )
            else:
                out[k] = v
        return out

    def override(self, other: Mapping | None) -> "Config":
        """Recursive update (infer-time config overrides)."""
        if not other:
            return self
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(self.get(k), Config):
                self[k].override(v)
            else:
                self[k] = v
        return self


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return Config(raw or {})
