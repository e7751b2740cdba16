"""Shared conv/activation primitives.

``Conv`` is ``nn.Conv2d`` (OIHW weight, torch padding and groups) with the
JAX package's compute-dtype rule (ops/common.py ``Conv``): parameters stay
fp32 and input, weight and bias are cast to the compute dtype at the call.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def gelu_exact(x):
    """erf-based GELU (torch.nn.functional.gelu default, Restormer.py:91)."""
    return F.gelu(x, approximate="none")


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype``.

    With ``dtype=None`` the compute dtype is the promotion of the input's and
    the weight's dtypes, as flax's ``promote_dtype`` gives it. The output
    keeps the input's memory format, so ``channels_last`` activations stay
    channels-last.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 groups: int = 1, bias: bool = True, dtype=None,
                 dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, groups=groups,
                         bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, self.dilation, self.groups)


def pad_to_multiple(x, multiple: int, mode: str = "reflect"):
    """Pad H and W of an NCHW tensor up to the next multiple.

    Returns (padded, (H, W)). Reflect padding matches numpy/JAX ``reflect``
    (the edge pixel is not repeated), as the reference's ``F.pad`` does.
    """
    h, w = x.shape[-2:]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode=mode)
    return x, (h, w)


def crop_to(x, hw: Sequence[int]):
    """Crop an NCHW tensor back to (H, W)."""
    return x[..., : hw[0], : hw[1]]
