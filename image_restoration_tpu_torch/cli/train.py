"""Model construction shared by the port's entry points
(image_restoration_tpu/cli/train.py ``build_model``). The training loop
itself comes with the training port."""

from __future__ import annotations

import torch


def default_device(cfg) -> torch.device:
    """``cfg["device"]`` when given, else the GPU. Without a GPU and without
    an explicit device this raises: the port's entry points run on the
    card, and the CPU only when the caller asks for it."""
    if cfg.get("device"):
        return torch.device(cfg["device"])
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --device cpu to run "
                           "on the CPU")
    return torch.device("cuda")


def build_model(cfg, device=None):
    """Registry model from ``cfg["model"]`` and ``cfg["model_kwargs"]``.

    Computes in bf16 unless ``cfg["bf16"]`` is False (parameters stay fp32).
    The random init is drawn from ``cfg["seed"]`` without touching the
    caller's global RNG state. Returned in eval mode on ``device`` (default:
    :func:`default_device`).
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
