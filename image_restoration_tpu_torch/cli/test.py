"""Checkpoint loading shared by the port's entry points
(image_restoration_tpu/cli/test.py ``load_params``). Benchmark evaluation
comes with the eval port."""

from __future__ import annotations

import numpy as np


def _unflatten(flat):
    """Flat ``a.b.c`` keys (the JAX package's ``save_params_npz``) to a
    nested dict."""
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *mods, leaf = key.split(".")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.asarray(arr)
    return tree


def load_params(cfg, model):
    """Load ``cfg["ckpt"]`` into ``model`` with a strict ``load_state_dict``.

    Torch ``.pth/.pt/.ckpt/.state`` files go through the envelope handling of
    ``utils.torch_import``; a ``.npz`` exported by the JAX package goes
    through ``utils.jax_bridge``, with the key map ``cfg["model"]`` was
    registered with; it holds params only, so BatchNorm statistics (LSNet)
    stay at the model's init, as in the JAX ``cli/robust.py``. From a torch
    checkpoint, keys that the key map sends to None and the model does not
    hold are dropped first: parameters the reference defines but never uses
    (AdaIR's ``fre*.conv`` and ``fre*.score_gen``). Without ``--ckpt`` the
    model keeps its random init.
    Returns the model.
    """
    path = cfg.get("ckpt")
    if not path:
        print("WARNING: no --ckpt given; using random init")
        return model
    from image_restoration_tpu_torch.models import KEY_MAPS

    key_map = KEY_MAPS.get(str(cfg.get("model", "")).lower())
    if path.endswith(".npz"):
        from image_restoration_tpu_torch.utils.jax_bridge import (
            state_dict_from_jax,
        )

        with np.load(path) as data:
            tree = _unflatten(dict(data))
        sd = state_dict_from_jax(tree, model.state_dict(), key_map)
    elif path.endswith((".pth", ".pt", ".ckpt", ".state")):
        from image_restoration_tpu_torch.utils.torch_import import (
            load_torch_checkpoint,
        )

        sd = load_torch_checkpoint(path, prefer_ema=cfg.get("prefer_ema", False))
        if key_map is not None:
            own = model.state_dict()
            sd = {k: v for k, v in sd.items()
                  if k in own or key_map(k) is not None}
    else:
        raise ValueError(f"{path}: the port reads torch .pth/.pt/.ckpt/.state "
                         f"and JAX .npz checkpoints (export orbax runs with "
                         f"save_params_npz)")
    model.load_state_dict(sd, strict=True)
    return model
