"""Illumination guidance of the Retinexformer lineage
(image_restoration_tpu/ops/illumination.py), NCHW: the estimator of
IGMoCE-IR and LumiSenseMoE (igmoce_ir.py:232-258) and IGMoCE-IR's
modulator (igmoce_ir.py:261-281)."""

from __future__ import annotations

import torch
from torch import nn

from image_restoration_tpu_torch.ops.common import Conv


class IlluminationEstimator(nn.Module):
    """[image; its channel mean] -> 1x1 conv -> 5x5 grouped conv (the
    illumination features) -> 1x1 conv (the illumination map). The 5x5
    conv has ``depth_groups`` groups: ``n_fea_in`` (4) when None, as in
    IGMoCE-IR; LumiSenseMoE passes ``n_fea_middle``."""

    def __init__(self, n_fea_middle: int, n_fea_in: int = 4,
                 n_fea_out: int = 3, depth_groups: int | None = None,
                 dtype=None):
        super().__init__()
        groups = n_fea_in if depth_groups is None else depth_groups
        self.conv1 = Conv(n_fea_in, n_fea_middle, 1, bias=True, dtype=dtype)
        self.depth_conv = Conv(n_fea_middle, n_fea_middle, 5, padding=2,
                               groups=groups, bias=True, dtype=dtype)
        self.conv2 = Conv(n_fea_middle, n_fea_out, 1, bias=True, dtype=dtype)

    def forward(self, img):
        x = torch.cat([img, img.mean(dim=1, keepdim=True)], dim=1)
        illu_fea = self.depth_conv(self.conv1(x))
        return illu_fea, self.conv2(illu_fea)


class AdaptiveIlluminationModulator(nn.Module):
    """3x3 conv -> GELU -> 3x3 conv -> sigmoid, both convs bias-free."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.modulate_conv = nn.Sequential(
            Conv(dim, dim, 3, padding=1, bias=False, dtype=dtype),
            nn.GELU(),
            Conv(dim, dim, 3, padding=1, bias=False, dtype=dtype))

    def forward(self, illu_fea):
        return torch.sigmoid(self.modulate_conv(illu_fea))
