"""NeRD-Rain's implicit neural representation head
(image_restoration_tpu/ops/inr.py), NCHW.

The reference's LIIF-style INR queries RGB on the feature map's own grid,
so its relative coordinates are zero, its four local-ensemble branches are
equal and its relative cell is the constant 2.0: it is one MLP pass over
[unfold3x3(feat); zeros(2 + 4 L); full(2, 2.0)], as the JAX package
computes it. The MLP's 256-wide products are plain matmuls.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.ops.common import Linear

L_FREQS = 4


def unfold3x3(x):
    """``F.unfold(k=3, pad=1)``'s channel layout on NCHW: (B, C, H, W) ->
    (B, C * 9, H, W) with channel c * 9 + (ki * 3 + kj), zero-padded."""
    b, c, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    taps = [xp[:, :, i:i + h, j:j + w] for i in range(3) for j in range(3)]
    return torch.stack(taps, dim=2).reshape(b, c * 9, h, w)


class MLP(nn.Module):
    """Linear + ReLU per hidden width, then a Linear to ``out_dim``, over
    the last axis; the layers sit at the torch Sequential's indices 0, 2,
    4, 6 (``layers.N``)."""

    def __init__(self, in_dim: int, out_dim: int = 3,
                 hidden: Sequence[int] = (256, 256, 256), dtype=None):
        super().__init__()
        mods, last = [], in_dim
        for hdim in hidden:
            mods += [Linear(last, hdim, dtype=dtype), nn.ReLU()]
            last = hdim
        mods.append(Linear(last, out_dim, dtype=dtype))
        self.layers = nn.Sequential(*mods)

    def forward(self, x):
        return self.layers(x)


class INR(nn.Module):
    """Feature map (B, dim, H, W) -> RGB (B, 3, H, W) at the same size."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.imnet = MLP(dim * 9 + 2 + 4 * L_FREQS + 2, 3, dtype=dtype)

    def forward(self, feat):
        q = unfold3x3(feat).permute(0, 2, 3, 1)
        b, h, w, _ = q.shape
        zeros = q.new_zeros((b, h, w, 2 + 4 * L_FREQS))
        cell = q.new_full((b, h, w, 2), 2.0)
        out = self.imnet(torch.cat([q, zeros, cell], dim=-1))
        return out.permute(0, 3, 1, 2)
