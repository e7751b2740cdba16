"""Gated-Dconv feed-forward network (Restormer.py:76-93), NCHW."""

from __future__ import annotations

from torch import nn

from image_restoration_tpu_torch.ops.common import Conv, gelu_exact


class GDFN(nn.Module):
    """1x1 expand to 2*hidden -> 3x3 depthwise -> gelu(x1) * x2 -> 1x1 out,
    with ``hidden = int(dim * expansion)``."""

    def __init__(self, dim: int, expansion: float = 2.66, bias: bool = False,
                 dtype=None):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = Conv(dim, hidden * 2, 1, bias=bias, dtype=dtype)
        self.dwconv = Conv(hidden * 2, hidden * 2, 3, padding=1,
                           groups=hidden * 2, bias=bias, dtype=dtype)
        self.project_out = Conv(hidden, dim, 1, bias=bias, dtype=dtype)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(gelu_exact(x1) * x2)
