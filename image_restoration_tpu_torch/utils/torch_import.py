"""Reading the reference zoo's checkpoints into the port.

The port's modules carry the reference torch attribute paths, so loading is a
plain strict ``load_state_dict``: what remains is taking the tensor dict out
of its envelope (Lightning ``.ckpt`` ``state_dict`` with a ``net.`` prefix,
BasicSR ``params`` / ``params_ema``, raw state dicts, DDP ``module.``
prefixes), as image_restoration_tpu/utils/torch_import.py does.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def strip_prefixes(state_dict: Mapping[str, Any],
                   prefixes=("module.", "net.", "model.")):
    """Strip a leading prefix shared by *all* keys (DDP/Lightning dumps)."""
    sd = dict(state_dict)
    changed = True
    while changed:
        changed = False
        for p in prefixes:
            if sd and all(k.startswith(p) for k in sd):
                sd = {k[len(p):]: v for k, v in sd.items()}
                changed = True
    return sd


def unwrap_checkpoint(obj: Any, prefer_ema: bool = False) -> Dict[str, Any]:
    """Pull the actual tensor dict out of the various checkpoint envelopes."""
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, Mapping):
        order = ("params_ema", "params") if prefer_ema else ("params", "params_ema")
        for key in order:
            if key in obj and isinstance(obj[key], Mapping):
                return dict(obj[key])
        for key in ("state_dict", "model", "net", "model_state_dict"):
            if key in obj and isinstance(obj[key], Mapping) and all(
                hasattr(v, "shape") or isinstance(v, np.ndarray)
                for v in obj[key].values()
            ):
                return dict(obj[key])
        if all(hasattr(v, "shape") or np.isscalar(v) for v in obj.values()):
            return dict(obj)
    raise ValueError(f"unrecognized checkpoint structure: {type(obj)}")


def load_torch_checkpoint(path: str, prefer_ema: bool = False) -> Dict[str, Any]:
    """``torch.load`` a checkpoint on the CPU and return its flat tensor dict
    with shared prefixes stripped, ready for ``load_state_dict``."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    return strip_prefixes(unwrap_checkpoint(obj, prefer_ema=prefer_ema))
