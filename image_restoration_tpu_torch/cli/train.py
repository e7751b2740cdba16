"""Model construction shared by the port's entry points
(image_restoration_tpu/cli/train.py ``build_model``). The training loop
itself comes with the training port."""

from __future__ import annotations

import torch


def default_device(cfg) -> torch.device:
    if cfg.get("device"):
        return torch.device(cfg["device"])
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def build_model(cfg, device=None):
    """Registry model from ``cfg["model"]`` and ``cfg["model_kwargs"]``.

    Computes in bf16 unless ``cfg["bf16"]`` is False (parameters stay fp32).
    The random init is drawn from ``cfg["seed"]`` without touching the
    caller's global RNG state. Returned in eval mode on ``device`` (default:
    the configured device, else the GPU when there is one).
    """
    from image_restoration_tpu_torch.models import get_model

    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg.get("model_kwargs", {}).items()}
    if cfg.get("bf16", True):
        kwargs.setdefault("dtype", torch.bfloat16)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.get("seed", 0))
        model = get_model(cfg["model"], **kwargs)
    return model.to(device or default_device(cfg)).eval()
