"""DarkIR (DarkIR-main/archs/{DarkIR.py:11-114, arch_model.py};
image_restoration_tpu/models/darkir.py), NCHW.

A NAFNet-lineage low-light and deblurring U-Net. Encoder ``EBlock``s: 1x1
expand, dilated depthwise branches, SimpleGate, simplified channel
attention, 1x1, then ``FreMLP`` frequency modulation. Decoder ``DBlock``s:
parallel dilated depthwise branches (dilations 1/4/9, summed) and a gated
FFN. Strided-conv downsamples, 1x1 + PixelShuffle upsamples, an optional
side head on the bottleneck for mid-supervision, zero pad to a multiple
of 2^levels and crop back. Plain torch throughout (plain XLA in JAX).
Attribute paths follow the JAX tree (``encoders.1.0.freq.process1.0``);
:func:`darkir_key_map` maps a reference state_dict onto them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.common import Conv
from image_restoration_tpu_torch.ops.fft import FreMLP
from image_restoration_tpu_torch.ops.layernorm import LayerNorm2d


def simple_gate(x):
    """NAFNet SimpleGate: the first half of the channels times the second
    (arch_model.py:12)."""
    x1, x2 = x.chunk(2, dim=1)
    return x1 * x2


class _Gated(nn.Module):
    """What EBlock and DBlock share: the sum of 3x3 depthwise branches at
    ``dilations`` over ``dw`` channels, SimpleGate, simplified channel
    attention (GAP, 1x1), 1x1 back to c, and ``beta`` and ``gamma``
    (zero at init)."""

    def __init__(self, c: int, dw: int, dilations: Sequence[int], dtype):
        super().__init__()
        self.branches = nn.ModuleList(
            Conv(dw, dw, 3, padding=d, dilation=d, groups=dw, dtype=dtype)
            for d in dilations)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                 Conv(dw // 2, dw // 2, 1, dtype=dtype))
        self.conv3 = Conv(dw // 2, c, 1, dtype=dtype)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def gated(self, inp, x):
        """inp + beta * (the branches of x through SimpleGate, SCA and
        conv3)."""
        z = self.branches[0](x)
        for br in self.branches[1:]:
            z = z + br(x)
        z = simple_gate(z)
        x = self.conv3(self.sca(z) * z)
        return inp + self.beta.to(x.dtype) * x


class EBlock(_Gated):
    """arch_model.py:141-204: norm, (depthwise 3x3,) 1x1 to 2c, the gated
    branches; then FreMLP of the normed result multiplies it, scaled by
    gamma."""

    def __init__(self, c: int, dw_expand: int = 2,
                 dilations: Sequence[int] = (1,),
                 extra_depth_wise: bool = True, dtype=None):
        dw = dw_expand * c
        super().__init__(c, dw, dilations, dtype)
        self.norm1 = LayerNorm2d(c)
        self.extra_conv = (Conv(c, c, 3, padding=1, groups=c, dtype=dtype)
                           if extra_depth_wise else None)
        self.conv1 = Conv(c, dw, 1, dtype=dtype)
        self.norm2 = LayerNorm2d(c)
        self.freq = FreMLP(c, expand=2)

    def forward(self, inp):
        x = self.norm1(inp)
        if self.extra_conv is not None:
            x = self.extra_conv(x)
        y = self.gated(inp, self.conv1(x))
        x = y * self.freq(self.norm2(y))
        return y + x * self.gamma.to(x.dtype)


class DBlock(_Gated):
    """arch_model.py:72-139: norm, 1x1 to 2c, (a 3x3 conv of groups c over
    the 2c channels, as the reference has it,) the gated branches; then a
    SimpleGate FFN scaled by gamma."""

    def __init__(self, c: int, dw_expand: int = 2, ffn_expand: int = 2,
                 dilations: Sequence[int] = (1, 4, 9),
                 extra_depth_wise: bool = True, dtype=None):
        dw = dw_expand * c
        super().__init__(c, dw, dilations, dtype)
        self.norm1 = LayerNorm2d(c)
        self.conv1 = Conv(c, dw, 1, dtype=dtype)
        self.extra_conv = (Conv(dw, dw, 3, padding=1, groups=c, dtype=dtype)
                           if extra_depth_wise else None)
        self.norm2 = LayerNorm2d(c)
        self.conv4 = Conv(c, ffn_expand * c, 1, dtype=dtype)
        self.conv5 = Conv(ffn_expand * c // 2, c, 1, dtype=dtype)

    def forward(self, inp):
        x = self.conv1(self.norm1(inp))
        if self.extra_conv is not None:
            x = self.extra_conv(x)
        y = self.gated(inp, x)
        x = self.conv5(simple_gate(self.conv4(self.norm2(y))))
        return y + x * self.gamma.to(x.dtype)


def darkir_key_map(key: str, keep_side: bool = False):
    """A reference checkpoint's keys onto the model's: CustomSequential
    nests blocks under ``modules_list`` (arch_util.CustomSequential), and
    ``side_out`` is dropped unless ``keep_side`` (a tree the JAX package
    initialised without the side head lacks it)."""
    if key.startswith("side_out") and not keep_side:
        return None
    return key.replace(".modules_list.", ".")


@register_model("darkir", key_map=darkir_key_map)
class DarkIR(nn.Module):
    """DarkIR.py:11-114. Takes NCHW and returns the fp32 restoration;
    ``forward(x, side_loss=True)`` returns ``(out, {"side": side})`` with
    the bottleneck's 3-channel side output (1/2^levels of the padded
    size). The side head always exists (the JAX model creates it when
    initialised with ``side_loss``)."""

    def __init__(self, img_channel: int = 3, width: int = 32,
                 middle_blk_num_enc: int = 2, middle_blk_num_dec: int = 2,
                 enc_blk_nums: Sequence[int] = (1, 2, 3),
                 dec_blk_nums: Sequence[int] = (3, 1, 1),
                 dilations: Sequence[int] = (1, 4, 9),
                 extra_depth_wise: bool = True, dtype=None):
        super().__init__()
        self.dtype, self.levels = dtype, len(enc_blk_nums)
        kw = dict(extra_depth_wise=extra_depth_wise, dtype=dtype)
        dkw = dict(kw, dilations=tuple(dilations))
        self.intro = Conv(img_channel, width, 3, padding=1, dtype=dtype)
        self.encoders, self.downs = nn.ModuleList(), nn.ModuleList()
        chan = width
        for num in enc_blk_nums:
            self.encoders.append(nn.ModuleList(EBlock(chan, **kw)
                                               for _ in range(num)))
            self.downs.append(Conv(chan, 2 * chan, 2, stride=2, dtype=dtype))
            chan *= 2
        self.middle_blks_enc = nn.ModuleList(
            EBlock(chan, **kw) for _ in range(middle_blk_num_enc))
        self.side_out = Conv(chan, img_channel, 3, padding=1, dtype=dtype)
        self.middle_blks_dec = nn.ModuleList(
            DBlock(chan, **dkw) for _ in range(middle_blk_num_dec))
        self.ups, self.decoders = nn.ModuleList(), nn.ModuleList()
        for num in dec_blk_nums:
            self.ups.append(nn.Sequential(
                Conv(chan, 2 * chan, 1, bias=False, dtype=dtype),
                nn.PixelShuffle(2)))
            chan //= 2
            self.decoders.append(nn.ModuleList(DBlock(chan, **dkw)
                                               for _ in range(num)))
        self.ending = Conv(width, img_channel, 3, padding=1, dtype=dtype)

    def forward(self, inp, side_loss: bool = False):
        h, w = inp.shape[-2:]
        pad = 2 ** self.levels
        x = F.pad(inp, (0, (-w) % pad, 0, (-h) % pad))
        inp_p = x
        x = x if self.dtype is None else x.to(self.dtype)
        x = self.intro(x.contiguous(memory_format=torch.channels_last))
        skips = []
        for blocks, down in zip(self.encoders, self.downs):
            for blk in blocks:
                x = blk(x)
            skips.append(x)
            x = down(x)
        for blk in self.middle_blks_enc:
            x = blk(x)
        x_light = x
        for blk in self.middle_blks_dec:
            x = blk(x)
        x = x + x_light
        for up, blocks, skip in zip(self.ups, self.decoders, skips[::-1]):
            x = up(x) + skip
            for blk in blocks:
                x = blk(x)
        x = self.ending(x)
        out = (x + inp_p.to(x.dtype)).float()[..., :h, :w]
        if side_loss:
            return out, {"side": self.side_out(x_light).float()}
        return out
