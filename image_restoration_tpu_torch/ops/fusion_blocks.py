"""Channel/spatial fusion conv blocks (reference FCM-and-MKP.py;
image_restoration_tpu/ops/fusion_blocks.py), NCHW.

:class:`FCM` splits the channels 1/4 : 3/4, runs a small conv stack on
the thin split and a 1x1 expansion on the wide one, gates the thin branch
with a spatial sigmoid map from the wide branch and the wide branch with a
channel sigmoid vector from the thin one, sums, and projects
(FCM-and-MKP.py:69-93). Its convs are YOLO-style Conv-BN-SiLU (:17-35).
The BatchNorms are fp32 and follow the forward's ``train`` argument, as
the JAX ``BatchNorm2d`` does: ``forward(x, train=True)`` normalises with
the batch's statistics and updates the running buffers, as the JAX apply
with ``mutable=["batch_stats"]``. Attribute paths are the reference's
(``spatial.conv1``, ``spatial.bn``, ``channel.dwconv``), which
:func:`fcm_key_map` maps onto the JAX tree. No Pallas kernel lies behind
this layer in JAX: plain torch here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.ops.common import Conv
from image_restoration_tpu_torch.ops.layernorm import BatchNorm2d, batch_norm


class ConvBNSiLU(nn.Module):
    """Conv-BN-SiLU (FCM-and-MKP.py:17-31): a bias-free conv (padding
    kernel // 2), BatchNorm, SiLU."""

    def __init__(self, in_ch: int, features: int, kernel: int = 1,
                 stride: int = 1, dtype=None):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel, stride=stride,
                         padding=kernel // 2, bias=False, dtype=dtype)
        self.bn = BatchNorm2d(features)

    def forward(self, x, train: bool = False):
        return F.silu(batch_norm(self.bn, self.conv(x), train))


class FCM(nn.Module):
    """FCM-and-MKP.py:69-93 over ``dim`` channels (a multiple of 4)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        q = dim // 4
        self.q = q
        self.conv1 = ConvBNSiLU(q, q, 3, dtype=dtype)
        self.conv12 = ConvBNSiLU(q, q, 3, dtype=dtype)
        self.conv123 = ConvBNSiLU(q, dim, 1, dtype=dtype)
        self.conv2 = ConvBNSiLU(dim - q, dim, 1, dtype=dtype)
        self.spatial = nn.ModuleDict({"conv1": Conv(dim, 1, 1, dtype=dtype),
                                      "bn": BatchNorm2d(1)})
        self.channel = nn.ModuleDict({"dwconv": Conv(
            dim, dim, 3, padding=1, groups=dim, dtype=dtype)})
        self.conv3 = ConvBNSiLU(dim, dim, 1, dtype=dtype)

    def forward(self, x, train: bool = False):
        x1, x2 = x[:, : self.q], x[:, self.q:]
        x3 = self.conv1(x1, train)
        x3 = self.conv123(self.conv12(x3, train), train)
        x4 = self.conv2(x2, train)
        # spatial gate from the wide branch (:55-67)
        s = batch_norm(self.spatial["bn"], self.spatial["conv1"](x4), train)
        s = torch.sigmoid(s)
        # channel gate from the thin branch (:37-52)
        ch = self.channel["dwconv"](x3)
        ch = torch.sigmoid(ch.mean((2, 3), keepdim=True))
        return self.conv3(s * x3 + ch * x4, train)


def fcm_key_map(key: str):
    """A reference (and this port's) FCM key -> the JAX module's path."""
    key = key.replace("spatial.conv1.", "spatial_conv1.")
    key = key.replace("spatial.bn.", "spatial_bn.")
    key = key.replace("channel.dwconv.", "channel_dwconv.")
    key = key.replace("channel.dconv.", "channel_dwconv.")
    return key
