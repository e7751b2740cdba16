"""Shared conv/dense/activation primitives.

``Conv`` is ``nn.Conv2d`` (OIHW weight, torch padding and groups) with the
JAX package's compute-dtype rule (ops/common.py ``Conv``): parameters stay
fp32 and input, weight and bias are cast to the compute dtype at the call.
``GroupedConv`` is the same for rectangular kernels with per-side padding
(the JAX ``GroupedConv``, without its custom gradient), and ``Linear`` the
same rule for flax's ``Dense``.
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


class GroupedConv(Conv):
    """``Conv`` with an (kh, kw) kernel and (ph, pw) padding, as the JAX
    ``GroupedConv`` takes them (``padding=[(0, 0), (p, p)]`` is ``(0, p)``
    here): MEASNet's striped 1xk and kx1 depthwise convs."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int], padding: Sequence[int] = (0, 0),
                 groups: int = 1, bias: bool = True, dtype=None):
        super().__init__(in_channels, out_channels, tuple(kernel_size),
                         padding=tuple(padding), groups=groups, bias=bias,
                         dtype=dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``Dense(dtype=...)``);
    with ``dtype=None`` in the promotion of the input's and the weight's
    dtypes."""

    def __init__(self, a: int, b: int, bias: bool = True, dtype=None):
        super().__init__(a, b, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


def layer_scale_init(value: float):
    """Initializer of a constant layer scale (the JAX ``layer_scale_init``):
    ``init(shape)`` is a tensor of ``value``."""
    def init(shape, dtype=torch.float32):
        return torch.full(tuple(shape), value, dtype=dtype)

    return init


def _reflect_pad_after(x, pad: int, dim: int):
    """Reflect-pad ``pad`` entries after the end of ``dim`` (-1 or -2) of an
    NCHW tensor, any ``pad``: ``F.pad`` takes less than the side at a time,
    so the pad grows in steps, each reflecting what is there, which gives
    the periodic reflection ``numpy.pad`` and ``jnp.pad`` give. A side of 1
    has nothing to reflect and repeats its one entry, as they do."""
    while pad > 0:
        n = x.shape[dim]
        step = pad if n == 1 else min(pad, n - 1)
        widths = (0, step, 0, 0) if dim == -1 else (0, 0, 0, step)
        x = F.pad(x, widths, mode="replicate" if n == 1 else "reflect")
        pad -= step
    return x


def pad_to_multiple(x, multiple: int, mode: str = "reflect"):
    """Pad H and W of an NCHW tensor up to the next multiple.

    Returns (padded, (H, W)). Reflect padding matches numpy/JAX ``reflect``
    (the edge pixel is not repeated) for every pad width, also one that is
    not smaller than the side.
    """
    h, w = x.shape[-2:]
    ph, pw = (-h) % multiple, (-w) % multiple
    if mode == "reflect":
        x = _reflect_pad_after(_reflect_pad_after(x, ph, -2), pw, -1)
    elif ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode=mode)
    return x, (h, w)


def crop_to(x, hw: Sequence[int]):
    """Crop an NCHW tensor back to (H, W)."""
    return x[..., : hw[0], : hw[1]]
