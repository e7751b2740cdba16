"""Pixel-(un)shuffle resamplers (Restormer.py:171-190) and the bilinear
resize, NCHW.

torch's own pixel (un)shuffle has the (c, i, j) channel sub-order that the
JAX package reproduces for checkpoint compatibility, so the port uses it
directly. ``Downsample`` is the plain 3x3 conv followed by the unshuffle: the
JAX package's stride-2 4x4 rewrite of the pair is a TPU layout trick.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.ops.common import Conv


def pixel_shuffle(x, r: int):
    """(B, C*r^2, H, W) -> (B, C, H*r, W*r), torch channel order."""
    return F.pixel_shuffle(x, r)


def pixel_unshuffle(x, r: int):
    """(B, C, H*r, W*r) -> (B, C*r^2, H, W), inverse of ``pixel_shuffle``."""
    return F.pixel_unshuffle(x, r)


def resize_bilinear(x, out_h: int, out_w: int):
    """Bilinear resize of NCHW ``x`` to (out_h, out_w)
    (image_restoration_tpu/ops/resample.py ``resize_bilinear``, on NHWC,
    with its default ``align_corners=False``).

    The JAX function is ``jax.image.resize(method="linear")``, whose
    ``antialias`` defaults to True: when it downsamples, its triangle filter
    widens by the scale factor. ``F.interpolate(antialias=True)`` computes
    the same filter, and equals the plain bilinear resize when it upsamples.
    """
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True)


class Downsample(nn.Module):
    """Bias-free 3x3 conv to C/2, then PixelUnshuffle(2): (2C, H/2, W/2)."""

    def __init__(self, n_feat: int, dtype=None):
        super().__init__()
        self.body = nn.Sequential(
            Conv(n_feat, n_feat // 2, 3, padding=1, bias=False, dtype=dtype),
            nn.PixelUnshuffle(2))

    def forward(self, x):
        return self.body(x)


class Upsample(nn.Module):
    """Bias-free 3x3 conv to 2C, then PixelShuffle(2): (C/2, 2H, 2W)."""

    def __init__(self, n_feat: int, dtype=None):
        super().__init__()
        self.body = nn.Sequential(
            Conv(n_feat, n_feat * 2, 3, padding=1, bias=False, dtype=dtype),
            nn.PixelShuffle(2))

    def forward(self, x):
        return self.body(x)
