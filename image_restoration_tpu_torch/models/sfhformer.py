"""SFHformer (SFHformer.py, ECCV'24 spatial-frequency hybrid mixer;
image_restoration_tpu/models/sfhformer.py), NCHW.

Each block: BatchNorm -> Mixer (a local dilated-depthwise branch and a
global Fourier branch: a grouped conv over the rfft2 coefficients with a
dynamic softmax over its groups; channel-attention fusion) -> a layer-scale
residual; BatchNorm -> a multi-kernel FFN -> a layer-scale residual. A
5-stage hourglass (32-64-128-64-32 by default) with 1x1-conv skips.

The BatchNorms follow the forward's ``train`` argument, not the module's
mode, as the JAX ``BatchNorm2d`` does: ``train=True`` normalises with the
batch's statistics and updates the running ones. The training CLI trains
with ``train=True`` (``trains_batch_stats``), as the reference trains;
the JAX CLI cannot (its step applies the parameters alone). The
Fourier branch runs in fp32 whatever the model's dtype, and GlobalMixer's
convs compute in the promotion of their input's and fp32 weights' dtypes
(fp32), as the JAX module, which is given no ``dtype``, does. Plain torch
throughout (plain XLA in JAX). Attribute paths follow the JAX tree
(``layer1.blocks.0.mixer.mixer_gloal.FFC.fdc.weight``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.common import Conv, gelu_exact
from image_restoration_tpu_torch.ops.fft import (
    channels_to_complex, complex_to_channels, irfft2, rfft2,
)
from image_restoration_tpu_torch.ops.layernorm import BatchNorm2d, batch_norm


def _conv1x1(cin, cout, dtype, bias=True):
    return Conv(cin, cout, 1, bias=bias, dtype=dtype)


class FFN(nn.Module):
    """The 4-way split multi-kernel FFN (SFHformer.py:76-117): 1x1 to 2
    dim, depthwise 3/5/7 on three of the four dim/2 slices, exact GELU,
    1x1 back."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        sp = dim // 2
        self.sp = sp
        self.conv_init = nn.Sequential(_conv1x1(dim, dim * 2, dtype))
        for i, k in enumerate((3, 5, 7), 1):
            setattr(self, f"conv1_{i}", nn.Sequential(
                Conv(sp, sp, k, padding=k // 2, groups=sp, dtype=dtype)))
        self.conv_fina = nn.Sequential(_conv1x1(dim * 2, dim, dtype))

    def forward(self, x):
        parts = list(self.conv_init(x).split(self.sp, dim=1))
        for i in (1, 2, 3):
            parts[i] = getattr(self, f"conv1_{i}")(parts[i])
        return self.conv_fina(gelu_exact(torch.cat(parts, dim=1)))


class LocalMixer(nn.Module):
    """Two depthwise 3x3 branches over the halves, the second dilated by 2
    (:121-140)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        sp = dim // 2
        self.CDilated_1 = Conv(sp, sp, 3, padding=1, groups=sp, dtype=dtype)
        self.CDilated_2 = Conv(sp, sp, 3, padding=2, dilation=2, groups=sp,
                               dtype=dtype)

    def forward(self, x):
        x1, x2 = x.chunk(2, dim=1)
        return torch.cat([self.CDilated_1(x1), self.CDilated_2(x2)], dim=1)


class FourierUnitGrouped(nn.Module):
    """A grouped complex conv with dynamic group mixing (:143-177), in
    fp32: the ortho rfft2 of x as 2c channels (each channel's real and
    imaginary parts interleaved, ``ops/fft.py`` ``complex_to_channels``,
    the JAX ``stack([re, im], -1)`` order), BatchNorm, a depthwise 3x3
    residual, a softmax over ``groups`` dynamic weights mixing ``groups``
    grouped 1x1 maps, exact GELU, the ortho irfft2 to x's size, cast to
    x's dtype."""

    def __init__(self, channels: int, groups: int = 4):
        super().__init__()
        c2, f32 = 2 * channels, torch.float32
        self.groups = groups
        self.bn = BatchNorm2d(c2)
        self.fpe = Conv(c2, c2, 3, padding=1, groups=c2, dtype=f32)
        self.weight = nn.Sequential(_conv1x1(c2, groups, f32))
        self.fdc = Conv(c2, c2 * groups, 1, groups=groups, dtype=f32)

    def forward(self, x, train: bool = False):
        h, w = x.shape[-2:]
        f = batch_norm(self.bn, complex_to_channels(rfft2(x, norm="ortho")),
                       train)
        f = f + self.fpe(f)
        dyw = torch.softmax(self.weight(f), dim=1)
        fd = self.fdc(f)
        b, _, hh, ww = fd.shape
        fd = fd.reshape(b, self.groups, -1, hh, ww)
        f = gelu_exact((dyw[:, :, None] * fd).sum(1))
        return irfft2(channels_to_complex(f), (h, w), norm="ortho",
                      dtype=x.dtype)


class GlobalMixer(nn.Module):
    """GELU(1x1 to 2 dim) -> FourierUnitGrouped, plus its input -> GELU(1x1
    back) (:180-206); no compute dtype of its own (see the module
    docstring)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_init = nn.Sequential(_conv1x1(dim, dim * 2, None))
        self.FFC = FourierUnitGrouped(dim * 2)
        self.conv_fina = nn.Sequential(_conv1x1(dim * 2, dim, None))

    def forward(self, x, train: bool = False):
        x0 = gelu_exact(self.conv_init(x))
        return gelu_exact(self.conv_fina(self.FFC(x0, train) + x0))


class Mixer(nn.Module):
    """1x1 to 2 dim, the local and global mixers on the halves, GELU,
    squeeze-excitation fusion and a 1x1 back (:209-251)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.conv_init = nn.Sequential(_conv1x1(dim, 2 * dim, dtype))
        self.mixer_local = LocalMixer(dim, dtype)
        self.mixer_gloal = GlobalMixer(dim)
        self.ca = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                _conv1x1(2 * dim, dim, dtype), nn.ReLU(),
                                _conv1x1(dim, 2 * dim, dtype), nn.Sigmoid())
        self.ca_conv = nn.Sequential(_conv1x1(2 * dim, dim, dtype))

    def forward(self, x, train: bool = False):
        xl, xg = self.conv_init(x).chunk(2, dim=1)
        x = gelu_exact(torch.cat([self.mixer_local(xl),
                                  self.mixer_gloal(xg, train)], dim=1))
        return self.ca_conv(self.ca(x) * x)


class Block(nn.Module):
    """x + beta * Mixer(BN(x)); then x + gamma * FFN(BN(x)). ``beta`` and
    ``gamma`` start at zero."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(1, dim, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, dim, 1, 1))
        self.norm1 = BatchNorm2d(dim)
        self.mixer = Mixer(dim, dtype)
        self.norm2 = BatchNorm2d(dim)
        self.ffn = FFN(dim, dtype)

    def forward(self, x, train: bool = False):
        h = self.mixer(batch_norm(self.norm1, x, train), train)
        x = x + h * self.beta.to(h.dtype)
        h = self.ffn(batch_norm(self.norm2, x, train))
        return x + h * self.gamma.to(h.dtype)


class Stage(nn.Module):
    def __init__(self, dim: int, depth: int, dtype=None):
        super().__init__()
        self.blocks = nn.ModuleList(Block(dim, dtype) for _ in range(depth))

    def forward(self, x, train: bool = False):
        for blk in self.blocks:
            x = blk(x, train)
        return x


@register_model("sfhformer")
class SFHformer(nn.Module):
    """The backbone (:306-360). Takes NCHW and returns the fp32
    restoration, the input plus the network's output; the _t/_s/_m/_l
    presets are depths."""

    trains_batch_stats = True  # cli/train.py: train with train=True

    def __init__(self, in_chans: int = 3, out_chans: int = 3,
                 embed_dim: Sequence[int] = (32, 64, 128, 64, 32),
                 depth: Sequence[int] = (2, 2, 4, 2, 2),
                 embed_kernel_size: int = 3, dtype=None):
        super().__init__()
        ed, kw = embed_dim, dict(dtype=dtype)
        self.dtype = dtype
        k = embed_kernel_size
        self.patch_embed = Conv(in_chans, ed[0], k, padding=k // 2, **kw)
        self.layer1 = Stage(ed[0], depth[0], **kw)
        self.downsample1 = Conv(ed[0], ed[0] * 2, 2, stride=2, **kw)
        self.layer2 = Stage(ed[1], depth[1], **kw)
        self.downsample2 = Conv(ed[1], ed[1] * 2, 2, stride=2, **kw)
        self.layer3 = Stage(ed[2], depth[2], **kw)
        self.upsample3 = Conv(ed[2], ed[3] * 4, 1, bias=False, **kw)
        self.skip2 = Conv(ed[3] + ed[1], ed[1], 1, **kw)
        self.layer8 = Stage(ed[3], depth[3], **kw)
        self.upsample4 = Conv(ed[3], ed[4] * 4, 1, bias=False, **kw)
        self.skip1 = Conv(ed[4] + ed[0], ed[0], 1, **kw)
        self.layer9 = Stage(ed[4], depth[4], **kw)
        self.patch_unembed = Conv(ed[4], out_chans, 3, padding=1, **kw)

    def forward(self, x, train: bool = False):
        inp = x
        x = x if self.dtype is None else x.to(self.dtype)
        x = self.layer1(self.patch_embed(x), train)
        c1 = x
        x = self.layer2(self.downsample1(x), train)
        c2 = x
        x = self.layer3(self.downsample2(x), train)
        x = F.pixel_shuffle(self.upsample3(x), 2)
        x = self.layer8(self.skip2(torch.cat([x, c2], dim=1)), train)
        x = F.pixel_shuffle(self.upsample4(x), 2)
        x = self.layer9(self.skip1(torch.cat([x, c1], dim=1)), train)
        return (inp + self.patch_unembed(x)).float()
