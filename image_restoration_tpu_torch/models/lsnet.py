"""LSNet (CVPR'25 "see large, focus small"): the classification backbone
of image_restoration_tpu/models/lsnet.py.

Conv+BN blocks: RepVGGDW + SqueezeExcite at even depths; at odd depths
LSConv (LKP, a large-kernel perception, predicts a 3x3 kernel per pixel,
which SKA applies) or, in the last stage, LeViT attention with trained
relative-position biases; a BN + Linear head on the mean-pooled features.

Attribute paths are the reference torch model's (``blocks1.1.mixer.lkp.cv4``,
``blocks4.1.mixer.m.proj.1.c``, ``head.bn``, ``head.l``), so its checkpoints
load with a strict ``load_state_dict``; JAX variables load through
``utils.jax_bridge`` with :func:`lsnet_key_map`.

Parameters stay fp32; ``dtype`` is the compute dtype every conv and the head
cast to, as in the JAX model. BatchNorm, GroupNorm, the attention logits
and softmax, and the SKA sums run in fp32. With ``use_pallas_ska`` (the JAX
field's name) SKA runs as the CUDA kernel of ``kernels/ska.py``; without
it, as the plain ``ops/ska.py`` ``ska_plain``, the oracle.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Sequence

import torch
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.common import Conv, Linear
from image_restoration_tpu_torch.ops.layernorm import (
    BatchNorm1d,
    BatchNorm2d,
    GroupNorm,
)
from image_restoration_tpu_torch.ops.ska import ska


def lsnet_key_map(key: str):
    """Reference torch key -> the key the JAX importer walks, or None for a
    key the JAX tree does not hold (lsnet.py ``lsnet_key_map``): the
    Residual wrappers' ``.m`` joins its parent, the head splits, the LeViT
    projection's Sequential index joins ``proj``."""
    if "attention_bias_idxs" in key:
        return None
    return (key.replace(".mixer.m.", ".mixer_m.")
            .replace(".ffn.m.", ".ffn_m.")
            .replace("head.bn.", "head_bn.").replace("head.l.", "head_l.")
            .replace(".proj.1.", ".proj_1."))


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()  # free when channels-last


def _nchw(x):
    return x.permute(0, 3, 1, 2)  # channels-last NCHW view


class ConvBN(nn.Sequential):
    """Conv (no bias) + BatchNorm (the reference's ``Conv2d_BN``)."""

    def __init__(self, a: int, b: int, ks: int = 1, stride: int = 1,
                 pad: int = 0, groups: int = 1, dtype=None):
        super().__init__()
        self.add_module("c", Conv(a, b, ks, stride, pad, groups, bias=False,
                                  dtype=dtype))
        self.add_module("bn", BatchNorm2d(b))


class SqueezeExcite(nn.Module):
    """timm SqueezeExcite(dim, 0.25): mean over HW, biased 1x1, ReLU,
    biased 1x1, sigmoid gate."""

    def __init__(self, dim: int, rd_ratio: float = 0.25, dtype=None):
        super().__init__()
        rd = int(dim * rd_ratio)
        self.conv_reduce = Conv(dim, rd, 1, dtype=dtype)
        self.conv_expand = Conv(rd, dim, 1, dtype=dtype)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = self.conv_expand(torch.relu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class RepVGGDW(nn.Module):
    """3x3 and 1x1 depthwise ConvBNs plus the identity."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.conv = ConvBN(dim, dim, 3, 1, 1, dim, dtype=dtype)
        self.conv1 = ConvBN(dim, dim, 1, 1, 0, dim, dtype=dtype)

    def forward(self, x):
        return self.conv(x) + self.conv1(x) + x


class FFN(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=None):
        super().__init__()
        self.pw1 = ConvBN(dim, hidden, dtype=dtype)
        self.pw2 = ConvBN(hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.pw2(torch.relu(self.pw1(x)))


class Residual(nn.Module):
    """x + m(x); the reference's wrapper, hence the ``.m`` in its keys."""

    def __init__(self, m: nn.Module):
        super().__init__()
        self.m = m

    def forward(self, x):
        return x + self.m(x)


class LKP(nn.Module):
    """Large-kernel perception: predicts per-pixel sks^2 weights for each
    of dim / groups weight channels, returned as (B, H, W, dim / groups,
    sks^2), a free view of the channels-last cv4 output (channel-major:
    weight channel, then tap)."""

    def __init__(self, dim: int, lks: int = 7, sks: int = 3, groups: int = 8,
                 dtype=None):
        super().__init__()
        d2 = dim // 2
        self.sks, self.wc = sks, dim // groups
        self.cv1 = ConvBN(dim, d2, dtype=dtype)
        self.cv2 = ConvBN(d2, d2, lks, 1, (lks - 1) // 2, d2, dtype=dtype)
        self.cv3 = ConvBN(d2, d2, dtype=dtype)
        self.cv4 = Conv(d2, sks ** 2 * self.wc, 1, dtype=dtype)
        self.norm = GroupNorm(self.wc, sks ** 2 * self.wc, eps=1e-5)

    def forward(self, x):
        h = torch.relu(self.cv1(x))
        h = torch.relu(self.cv3(self.cv2(h)))
        w = _nhwc(self.norm(self.cv4(h)))
        b, hh, ww, _ = w.shape
        return w.view(b, hh, ww, self.wc, self.sks ** 2)


class LSConv(nn.Module):
    """bn(SKA(x, LKP(x))) + x."""

    def __init__(self, dim: int, use_pallas_ska: bool = False, dtype=None):
        super().__init__()
        self.use_pallas_ska = use_pallas_ska
        self.lkp = LKP(dim, dtype=dtype)
        self.bn = BatchNorm2d(dim)

    def forward(self, x):
        y = ska(_nhwc(x), self.lkp(x), self.use_pallas_ska)
        return self.bn(_nchw(y)) + x


class LeViTAttention(nn.Module):
    """LeViT attention with relative-position biases (lsnet.py:139-189).

    Channels are head-major. Only q passes the 3x3 depthwise ConvBN. The
    logits q.k * key_dim^-0.5 + bias, and their softmax, are fp32 (q and k
    in the compute dtype, products exact); the probabilities are rounded to
    the compute dtype before attn . v, which sums in fp32. ReLU, then
    ``proj.1``. An input of n < resolution^2 pixels takes the biases'
    leading n x n block, as the JAX model does.
    """

    def __init__(self, dim: int, key_dim: int, num_heads: int,
                 attn_ratio: float, resolution: int, dtype=None):
        super().__init__()
        self.num_heads, self.key_dim = num_heads, key_dim
        self.nh_kd = num_heads * key_dim
        self.d = int(attn_ratio * key_dim)
        self.dh = self.d * num_heads
        points = list(itertools.product(range(resolution), range(resolution)))
        offsets, idxs = {}, []
        for p1 in points:
            for p2 in points:
                off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
                idxs.append(offsets.setdefault(off, len(offsets)))
        self.attention_biases = nn.Parameter(torch.zeros(num_heads,
                                                         len(offsets)))
        self.register_buffer("attention_bias_idxs", torch.tensor(
            idxs, dtype=torch.long).view(len(points), len(points)))
        self.qkv = ConvBN(dim, self.dh + 2 * self.nh_kd, dtype=dtype)
        self.dw = ConvBN(self.nh_kd, self.nh_kd, 3, 1, 1, self.nh_kd,
                         dtype=dtype)
        self.proj = nn.Sequential(nn.ReLU(),
                                  ConvBN(self.dh, dim, dtype=dtype))

    def forward(self, x):
        b, _, h, w = x.shape
        n, nh, dt = h * w, self.num_heads, x.dtype
        q, k, v = self.qkv(x).split([self.nh_kd, self.nh_kd, self.dh], dim=1)
        q = self.dw(q)

        def heads(t):  # (B, C, H, W) -> (B, heads, n, C / heads), fp32
            return _nhwc(t).reshape(b, n, nh, -1).transpose(1, 2).float()

        attn = heads(q) @ heads(k).transpose(-1, -2) * self.key_dim ** -0.5
        idx = self.attention_bias_idxs[:n, :n]
        attn = attn + self.attention_biases[:, idx].float()
        attn = torch.softmax(attn, dim=-1).to(dt).float()
        out = (attn @ heads(v)).to(dt)  # (B, heads, n, d)
        out = out.transpose(1, 2).reshape(b, h, w, self.dh)
        return self.proj(_nchw(out))


class LSBlock(nn.Module):
    """The reference's ``Block``: RepVGGDW + SE at even depths; LeViT
    attention (stage 3) or LSConv (stages 0-2) at odd depths; then the
    residual FFN."""

    def __init__(self, dim: int, key_dim: int, num_heads: int,
                 attn_ratio: float, resolution: int, stage: int,
                 depth_idx: int, use_pallas_ska: bool = False, dtype=None):
        super().__init__()
        if depth_idx % 2 == 0:
            self.mixer = RepVGGDW(dim, dtype=dtype)
            self.se = SqueezeExcite(dim, dtype=dtype)
        elif stage == 3:
            self.mixer = Residual(LeViTAttention(dim, key_dim, num_heads,
                                                 attn_ratio, resolution,
                                                 dtype=dtype))
            self.se = nn.Identity()
        else:
            self.mixer = LSConv(dim, use_pallas_ska, dtype=dtype)
            self.se = nn.Identity()
        self.ffn = Residual(FFN(dim, dim * 2, dtype=dtype))

    def forward(self, x):
        return self.ffn(self.se(self.mixer(x)))


@register_model("lsnet", key_map=lsnet_key_map)
class LSNet(nn.Module):
    """LSNet on NCHW images; returns fp32 logits (B, num_classes), the
    pooled features when ``num_classes`` is 0, or with ``features`` the four
    stage maps (strides 8/16/32/64), the dense-prediction backbone mode.

    Variants (lsnet.py:221-222): T (64,128,192,256) / (1,2,3,4), the
    defaults; S (96,192,320,448) / (1,2,8,10); B (128,256,384,512) /
    (4,6,8,10).
    """

    def __init__(self, img_size: int = 224, patch_size: int = 8,
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: Sequence[int] = (64, 128, 192, 256),
                 key_dim: Sequence[int] = (16, 16, 16, 16),
                 depth: Sequence[int] = (1, 2, 3, 4),
                 num_heads: Sequence[int] = (4, 4, 4, 4),
                 use_pallas_ska: bool = False, features: bool = False,
                 dtype=None):
        super().__init__()
        ed = list(embed_dim)
        self.dtype, self.features = dtype, features
        self.patch_embed = nn.Sequential(
            ConvBN(in_chans, ed[0] // 4, 3, 2, 1, dtype=dtype), nn.ReLU(),
            ConvBN(ed[0] // 4, ed[0] // 2, 3, 2, 1, dtype=dtype), nn.ReLU(),
            ConvBN(ed[0] // 2, ed[0], 3, 2, 1, dtype=dtype))
        resolution = img_size // patch_size
        for i in range(4):
            stage = nn.Sequential()
            if i > 0:  # the downsample pair heads this stage's Sequential
                stage.append(ConvBN(ed[i - 1], ed[i - 1], 3, 2, 1, ed[i - 1],
                                    dtype=dtype))
                stage.append(ConvBN(ed[i - 1], ed[i], dtype=dtype))
                resolution = (resolution - 1) // 2 + 1
            ar = ed[i] / (key_dim[i] * num_heads[i])
            for d in range(depth[i]):
                stage.append(LSBlock(ed[i], key_dim[i], num_heads[i], ar,
                                     resolution, i, d, use_pallas_ska,
                                     dtype=dtype))
            setattr(self, f"blocks{i + 1}", stage)
        # the backbone mode has no head, as the JAX model creates none
        self.head = nn.Identity() if features or num_classes <= 0 else (
            nn.Sequential(OrderedDict(
                bn=BatchNorm1d(ed[-1]),
                l=Linear(ed[-1], num_classes, dtype=dtype))))

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.patch_embed(x.contiguous(memory_format=torch.channels_last))
        feats = []
        for i in range(4):
            x = getattr(self, f"blocks{i + 1}")(x)
            feats.append(x)
        if self.features:
            return feats
        return self.head(x.mean((2, 3))).float()
