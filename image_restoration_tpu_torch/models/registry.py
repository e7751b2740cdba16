"""Model registry: name -> constructor (image_restoration_tpu/models/registry.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict

MODELS: Dict[str, Callable[..., Any]] = {}


def register_model(name: str):
    def deco(ctor):
        MODELS[name.lower()] = ctor
        return ctor

    return deco


def get_model(name: str, **kwargs):
    """Build a registered model; unknown names raise KeyError listing the
    available ones."""
    key = name.lower()
    if key not in MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[key](**kwargs)
