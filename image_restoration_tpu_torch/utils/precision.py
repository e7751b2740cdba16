"""fp32 at full precision on the GPU."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """fp32 products and convolutions at full precision, not TF32, as the
    JAX CLI's ``jax.default_matmul_precision("highest")``; the caller's
    settings come back on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
