"""SRConvNet (SRConvNet-main/models/{m_network.py:11-54, m_block.py};
image_restoration_tpu/models/srconvnet.py), NCHW.

Lightweight super-resolution net: ``FConvMod`` Fourier-modulated attention
and a ``MixFFN`` whose two depthwise branches take per-sample kernels
(dynamic kernel aggregation), then a pixel-shuffle upsampler over a
bilinear skip of the input.

The port runs the reference's order of operations. The JAX model's TPU
layouts of the same functions are not ported: its upsampler computed
before the shuffle with the 3x3 tail as a polyphase sum
(``_tail_polyphase``), MixFFN's single 7x7 bank with the 5x5 bank
zero-padded and its channel interleave folded into ``proj_out``'s rows,
and the ``grouped_conv`` route. The per-sample kernels run as the
reference runs them: one ``F.conv2d`` over the batch folded into the
channels, ``groups=B*groups`` (m_block.py:134-150). Plain torch
throughout (plain XLA in JAX). Attribute paths follow the JAX tree
(``blocks.0.ffn.conv1.aggregation.weight``); :func:`srconvnet_key_map`
drops the reference's unused MeanShift buffers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.common import Conv, gelu_exact
from image_restoration_tpu_torch.ops.fft import FourierUnit
from image_restoration_tpu_torch.ops.layernorm import LayerNorm2d
from image_restoration_tpu_torch.ops.resample import resize_bilinear


class FConvMod(nn.Module):
    """Fourier-modulated conv attention (m_block.py:72-109): the softmax
    over H*W of ``FourierUnit(norm(x)) * v(norm(x))``, scaled per head by
    ``layer_scale`` (1e-6 at init), plus a depthwise positional conv of x,
    projected, plus x."""

    def __init__(self, dim: int, num_heads: int, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.layer_scale = nn.Parameter(torch.full((num_heads,), 1e-6))
        self.CPE = Conv(dim, dim, 3, padding=1, groups=dim, dtype=dtype)
        self.norm = LayerNorm2d(dim)
        self.a = FourierUnit(dim, dtype=dtype)
        self.v = Conv(dim, dim, 1, dtype=dtype)
        self.proj = Conv(dim, dim, 1, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        heads = self.num_heads
        pos = self.CPE(x)
        xn = self.norm(x)
        am = (self.a(xn) * self.v(xn)).reshape(b, heads, c // heads, h * w)
        am = am * self.layer_scale.to(am.dtype).reshape(1, heads, 1, 1)
        attn = torch.softmax(am.float(), dim=-1).to(x.dtype)
        return self.proj(attn.reshape(b, c, h, w) + pos) + x


class KernelAttention(nn.Module):
    """GAP -> 1x1 -> GELU -> 1x1 -> sigmoid: (B, num_kernels) weights of
    the kernel bank (m_block.py:153-174)."""

    def __init__(self, dim: int, num_kernels: int, reduction: int = 8,
                 dtype=None):
        super().__init__()
        mid = dim // reduction if dim != 3 else num_kernels
        self.conv1 = Conv(dim, mid, 1, dtype=dtype)
        self.conv2 = Conv(mid, num_kernels, 1, dtype=dtype)

    def forward(self, x):
        g = x.mean(dim=(2, 3), keepdim=True)
        g = self.conv2(gelu_exact(self.conv1(g)))
        return torch.sigmoid(g.reshape(x.shape[0], -1))


def he_uniform_(weight, fan_in: int):
    """flax's ``he_uniform``: uniform in +-sqrt(6 / fan_in), in place."""
    bound = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound)


class KernelAggregation(nn.Module):
    """The attention-weighted sum of a bank of ``num_kernels`` kernels,
    one per sample, applied as one grouped conv with the batch folded into
    the channels (m_block.py:113-150). ``weight`` is (num_kernels, dim,
    dim // groups, k, k), drawn as JAX's ``he_uniform(in_axis=(2, 3, 4),
    out_axis=1)`` (its fan counts the bank too); ``bias`` (num_kernels,
    dim) starts at zero."""

    def __init__(self, dim: int, kernel_size: int, groups: int,
                 num_kernels: int, use_bias: bool = True):
        super().__init__()
        self.groups, self.kernel_size = groups, kernel_size
        cig = dim // groups
        self.weight = nn.Parameter(torch.empty(num_kernels, dim, cig,
                                               kernel_size, kernel_size))
        he_uniform_(self.weight, num_kernels * cig * kernel_size ** 2)
        self.bias = (nn.Parameter(torch.zeros(num_kernels, dim))
                     if use_bias else None)

    def forward(self, x, attention):
        b, c, h, w = x.shape
        att = attention.float()
        wk = torch.einsum("bk,kdcij->bdcij", att, self.weight)
        k = self.kernel_size
        out = F.conv2d(x.reshape(1, b * c, h, w),
                       wk.reshape(-1, *wk.shape[2:]).to(x.dtype),
                       padding=k // 2, groups=b * self.groups)
        out = out.reshape(b, -1, h, w)
        if self.bias is not None:
            bias = (att @ self.bias).to(x.dtype)
            out = out + bias.reshape(b, -1, 1, 1)
        return out


class DynamicKernelAggregation(nn.Module):
    """KernelAttention's weights of x, then KernelAggregation of x."""

    def __init__(self, dim: int, kernel_size: int, groups: int = 1,
                 num_kernels: int = 4, dtype=None):
        super().__init__()
        self.attention = KernelAttention(dim, num_kernels, dtype=dtype)
        self.aggregation = KernelAggregation(dim, kernel_size, groups,
                                             num_kernels)

    def forward(self, x):
        return self.aggregation(x, self.attention(x))


class MixFFN(nn.Module):
    """Dual-branch FFN (m_block.py:204-226): norm, 1x1 to 2C and GELU; the
    halves through a 5x5 and a 7x7 depthwise branch (dynamic kernels when
    ``num_kernels`` > 1, plain convs otherwise), each GELU'd; the branch
    outputs interleaved channel by channel (c, branch), projected to C,
    plus x."""

    def __init__(self, dim: int, num_kernels: int, dtype=None):
        super().__init__()
        self.norm = LayerNorm2d(dim)
        self.proj_in = Conv(dim, dim * 2, 1, dtype=dtype)
        if num_kernels > 1:
            self.conv1 = DynamicKernelAggregation(dim, 5, dim, num_kernels,
                                                  dtype)
            self.conv2 = DynamicKernelAggregation(dim, 7, dim, num_kernels,
                                                  dtype)
        else:
            self.conv1 = Conv(dim, dim, 5, padding=2, groups=dim, dtype=dtype)
            self.conv2 = Conv(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.proj_out = Conv(dim * 2, dim, 1, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        x1, x2 = gelu_exact(self.proj_in(self.norm(x))).chunk(2, dim=1)
        st = torch.stack([gelu_exact(self.conv1(x1)),
                          gelu_exact(self.conv2(x2))], dim=2)
        return self.proj_out(st.reshape(b, 2 * c, h, w)) + x


def srconvnet_key_map(key: str):
    """Drop the reference checkpoints' MeanShift buffers, which its forward
    never uses."""
    if key.startswith(("sub_mean", "add_mean")):
        return None
    return key


class BasicBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, num_kernels: int,
                 dtype=None):
        super().__init__()
        self.attention = FConvMod(dim, num_heads, dtype)
        self.ffn = MixFFN(dim, num_kernels, dtype)

    def forward(self, x):
        return self.ffn(self.attention(x))


@register_model("srconvnet", key_map=srconvnet_key_map)
class SRNet(nn.Module):
    """m_network.py:11-54. Takes NCHW in [0, 1] and returns the fp32 image
    ``scale`` x larger: the upsampler (1x1, pixel shuffle, GELU, twice at
    x4, once at x2 or x3) and the 3x3 tail, plus a bilinear resize of the
    input."""

    def __init__(self, dim: int = 64, n_blocks: int = 10, num_heads: int = 8,
                 num_kernels: int = 4, scale: int = 4, colors: int = 3,
                 dtype=None):
        super().__init__()
        self.dtype, self.scale = dtype, scale
        self.to_feat = Conv(colors, dim, 3, padding=1, dtype=dtype)
        self.blocks = nn.Sequential(*(
            BasicBlock(dim, num_heads, num_kernels, dtype)
            for _ in range(n_blocks)))
        stages = [(4, 2), (4, 2)] if scale == 4 else [(scale ** 2, scale)]
        layers = []
        for mult, r in stages:
            layers += [Conv(dim, dim * mult, 1, dtype=dtype),
                       nn.PixelShuffle(r), nn.GELU()]
        self.upsampling = nn.Sequential(*layers)
        self.tail = Conv(dim, colors, 3, padding=1, dtype=dtype)

    def forward(self, x):
        base = x
        x = x if self.dtype is None else x.to(self.dtype)
        feat = self.to_feat(x.contiguous(memory_format=torch.channels_last))
        h = self.blocks(feat) + feat
        out = self.tail(self.upsampling(h)).float()
        hb, wb = base.shape[2] * self.scale, base.shape[3] * self.scale
        return out + resize_bilinear(base.float(), hb, wb)

