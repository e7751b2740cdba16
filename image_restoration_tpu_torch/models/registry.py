"""Model registry: name -> constructor (image_restoration_tpu/models/registry.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

MODELS: Dict[str, Callable[..., Any]] = {}
# reference torch key -> the key the JAX importer walks (None: a key the JAX
# tree does not hold), where a model's torch names need rewriting before
# utils.jax_bridge can place them
KEY_MAPS: Dict[str, Callable[[str], Optional[str]]] = {}


def register_model(name: str,
                   key_map: Optional[Callable[[str], Optional[str]]] = None):
    def deco(ctor):
        MODELS[name.lower()] = ctor
        if key_map is not None:
            KEY_MAPS[name.lower()] = key_map
        return ctor

    return deco


def get_model(name: str, **kwargs):
    """Build a registered model; unknown names raise KeyError listing the
    available ones."""
    key = name.lower()
    if key not in MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[key](**kwargs)
