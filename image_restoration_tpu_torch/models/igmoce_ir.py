"""IGMoCE-IR: illumination-guided MoCE (IGMoCE-IR-main/src/net/igmoce_ir.py;
image_restoration_tpu/models/igmoce_ir.py), NCHW.

A Retinexformer-style estimator modulates the input (x * illu_map + x) and
feeds an illumination stream down the encoder. Encoder blocks split the
normed channels odd/even into an ``IG_MSA`` attention branch (V scaled by
a learned modulation of the illumination features) and a ``SpAM`` gate
branch (NAFNet dilated depthwise convs and SCA), fused spatially and
"spectrally", with a ``FreMLPExp`` FFN on the rfft2 magnitude. The decoder
is MoCE-IR's complexity-expert mixture routed on the image gate alone,
always combined densely, with a SpAM shared branch.

Reference quirks kept, as in JAX (igmoce_ir.py:217-230): the frequency
fusion irfft2(rfft2(a) + rfft2(b)) is a + b, summed in fp32; its dim/2
channels are tiled twice; the FFN residual is anchored on the normed
tensor. Holistic LayerNorms normalise over H, W and C jointly. No internal
pad: ``make_restore_fn``'s multiple of 8 covers the three downsamples.
Plain torch throughout (plain XLA in JAX). Training routes with noise and
returns the aux loss as MoCE-IR does (``forward(img, train=True,
generator=g)``).
Attribute paths follow the JAX tree (``enc.0.0.1.mixer.qkv.weight``);
:func:`igmoce_key_map` maps a reference state_dict onto them.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from image_restoration_tpu_torch.models.adair import ChannelCrossAttention
from image_restoration_tpu_torch.models.moce_ir import (
    RoutingFunction,
    expert_banks,
    expert_complexity,
    gap,
)
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.attention import mdta_attention
from image_restoration_tpu_torch.ops.common import Conv
from image_restoration_tpu_torch.ops.fft import FreMLP
from image_restoration_tpu_torch.ops.ffn import GDFN
from image_restoration_tpu_torch.ops.illumination import (
    AdaptiveIlluminationModulator,
    IlluminationEstimator,
)
from image_restoration_tpu_torch.ops.layernorm import (
    BiasFreeLayerNorm,
    WithBiasLayerNorm,
)
from image_restoration_tpu_torch.ops.moe import dense_moe_combine
from image_restoration_tpu_torch.ops.resample import Downsample, Upsample


class HolisticLayerNorm(nn.Module):
    """LN over (C, H, W) jointly per sample (igmoce_ir.py:490-516): fp32
    statistics, biased variance, a per-channel affine (bias optional),
    cast back to x's dtype."""

    def __init__(self, dim: int, with_bias: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if with_bias else None

    def forward(self, x):
        xf = x.float()
        var, mu = torch.var_mean(xf, dim=(1, 2, 3), keepdim=True,
                                 correction=0)
        y = (xf - mu) / torch.sqrt(var + self.eps) * self.weight[:, None, None]
        if self.bias is not None:
            y = y + self.bias[:, None, None]
        return y.to(x.dtype)


class LN(nn.Module):
    """The LayerNorm dispatcher with the holistic variants
    (igmoce_ir.py:517-537); the norm lives under ``body``, channel norms
    over the channels of NCHW."""

    def __init__(self, dim: int, ln_type: str = "WithBias"):
        super().__init__()
        self.channel = ln_type in ("BiasFree", "WithBias")
        if ln_type == "BiasFree":
            self.body = BiasFreeLayerNorm(dim)
        elif ln_type == "WithBias":
            self.body = WithBiasLayerNorm(dim)
        elif ln_type in ("HolisticWithBias", "WithBias_Holistic_LayerNorm"):
            self.body = HolisticLayerNorm(dim, True)
        elif ln_type in ("HolisticBiasFree", "BiasFree_Holistic_LayerNorm"):
            self.body = HolisticLayerNorm(dim, False)
        else:
            raise NotImplementedError(ln_type)

    def forward(self, x):
        if self.channel:
            return self.body(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return self.body(x)


class FreMLPExp(FreMLP):
    """``ops/fft.py`` ``FreMLP`` with IGMoCE-IR's names and default: an
    fp32 MLP on the rfft2 magnitude, the phase kept (igmoce_ir.py:130-150),
    biases off unless ``use_bias``."""

    def __init__(self, dim: int, expansion: int = 2, use_bias: bool = False):
        super().__init__(dim, expansion, use_bias)


class SpAM(nn.Module):
    """NAFNet-style spatial attention (igmoce_ir.py:381-426): 1x1 to
    ``dw_expand`` x dim, the sum of 3x3 depthwise convs at ``dilations``,
    SimpleGate, simplified channel attention (GAP, 1x1), 1x1 back, and a
    residual scaled by ``beta`` (zero at init)."""

    def __init__(self, dim: int, dw_expand: int = 2,
                 dilations: Sequence[int] = (1,),
                 extra_depth_wise: bool = False, dtype=None):
        super().__init__()
        dw = dw_expand * dim
        self.extra_conv = (Conv(dim, dim, 3, padding=1, groups=dim, bias=True,
                                dtype=dtype) if extra_depth_wise else None)
        self.conv1 = Conv(dim, dw, 1, bias=True, dtype=dtype)
        self.branches = nn.ModuleList(
            Conv(dw, dw, 3, padding=d, dilation=d, groups=dw, bias=True,
                 dtype=dtype) for d in dilations)
        self.sca = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            Conv(dw // 2, dw // 2, 1, bias=True, dtype=dtype))
        self.conv3 = Conv(dw // 2, dim, 1, bias=True, dtype=dtype)
        self.beta = nn.Parameter(torch.zeros(1, dim, 1, 1))

    def forward(self, inp):
        x = inp if self.extra_conv is None else self.extra_conv(inp)
        x = self.conv1(x)
        z = 0.0
        for br in self.branches:
            z = z + br(x)
        z1, z2 = z.chunk(2, dim=1)
        z = z1 * z2
        sca = self.sca[1](gap(z)[:, :, None, None])  # the pool: gap's rounding
        x = self.conv3(sca * z)
        return inp + self.beta.to(x.dtype) * x


class IG_MSA(nn.Module):
    """Illumination-guided MDTA (igmoce_ir.py:283-343): V scaled by a
    learned modulation of the illumination features, and a depthwise
    positional branch on the unscaled V."""

    def __init__(self, dim: int, num_heads: int, use_bias: bool = False,
                 dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        # the illumination features carry dim channels at every level
        self.illumination_modulator = AdaptiveIlluminationModulator(
            dim, dtype)
        self.qkv = Conv(dim, dim * 3, 1, bias=use_bias, dtype=dtype)
        self.qkv_dwconv = Conv(dim * 3, dim * 3, 3, padding=1,
                               groups=dim * 3, bias=use_bias, dtype=dtype)
        self.proj = Conv(dim, dim, 1, bias=use_bias, dtype=dtype)
        self.pos_emb = nn.Sequential(
            Conv(dim, dim, 3, padding=1, groups=dim, bias=False, dtype=dtype),
            nn.GELU(),
            Conv(dim, dim, 3, padding=1, groups=dim, bias=False, dtype=dtype))

    def forward(self, x, illu_fea):
        illu_mod = self.illumination_modulator(illu_fea)
        q, k, v_inp = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        out = mdta_attention(q, k, v_inp * illu_mod, self.temperature,
                             self.num_heads)
        return self.proj(out) + self.pos_emb(v_inp)


class IGEncoderBlock(nn.Module):
    """Odd/even channel split of the normed input into IG_MSA and SpAM,
    spatial and frequency fusion scaled by ``gamma``, FreMLPExp FFN scaled
    by ``beta`` on the normed sum (igmoce_ir.py:538-612)."""

    def __init__(self, dim: int, num_heads: int, expansion: int = 2,
                 use_bias: bool = True, ln_type: str = "HolisticWithBias",
                 dw_expand: int = 2, dilations: Sequence[int] = (1, 2, 4),
                 fusion_weight: float = 0.5, dtype=None):
        super().__init__()
        half = dim // 2
        self.fusion_weight = fusion_weight
        self.gamma = nn.Parameter(torch.zeros(1, dim, 1, 1))
        self.beta = nn.Parameter(torch.zeros(1, dim, 1, 1))
        self.norms = nn.ModuleList([LN(dim, ln_type), LN(half, ln_type),
                                    LN(half, ln_type), LN(dim, ln_type)])
        self.mixer = IG_MSA(half, num_heads, use_bias, dtype=dtype)
        self.spam = SpAM(half, dw_expand, dilations, dtype=dtype)
        self.ffn = FreMLPExp(dim, expansion, use_bias)

    def forward(self, x, illu_fea):
        dt = x.dtype
        xn = self.norms[0](x)
        f_att = self.mixer(self.norms[1](xn[:, 1::2]), illu_fea)
        f_gate = self.spam(self.norms[2](xn[:, 0::2]))
        f_s = torch.cat([f_att + torch.sigmoid(f_gate),
                         f_gate + torch.sigmoid(f_att)], dim=1)
        f_f = (f_att.float() + f_gate.float()).to(dt)
        f_f = torch.cat([f_f, f_f], dim=1)
        w = self.fusion_weight
        fuse = (w * f_s + (1 - w) * f_f) * self.gamma.to(dt) + x
        fuse = self.norms[3](fuse)
        return fuse + self.beta.to(dt) * self.ffn(fuse)


class IGAdapterLayer(nn.Module):
    """MoCE-IR's adapter routed on the image gate alone (the reference's
    ``freq_gate`` exists in its checkpoints and is never used), always
    combined densely, then ``proj_out``; in training ``(out, aux)`` with
    the noise, balance loss and complexity bias of MoCE-IR's
    ``AdapterLayer`` (JAX igmoce_ir.py:249-271)."""

    def __init__(self, dim: int, rank: int, num_experts: int = 4,
                 top_k: int = 1, rank_type: str = "constant",
                 with_complexity: bool = False, complexity_scale: str = "max",
                 dtype=None):
        super().__init__()
        self.routing = RoutingFunction(
            dim, dim, num_experts, top_k,
            expert_complexity(dim, rank, num_experts, rank_type,
                              complexity_scale) if with_complexity else None,
            use_freq_gate=False)
        self.experts = expert_banks(dim, rank, num_experts, rank_type, dtype)
        self.proj_out = Conv(dim, dim, 1, bias=False, dtype=dtype)

    def forward(self, x, shared, train=False, generator=None):
        gates, _, _, aux = self.routing(x, None, train=train,
                                        generator=generator)
        out = dense_moe_combine(gates, [e[0](x, shared) for e in self.experts])
        out = self.proj_out(out)
        return (out, aux) if train else out


class IGDecoderBlock(nn.Module):
    """MoCE-IR's DecoderBlock with a SpAM shared branch (dilations 1, 2, 4)
    and the image-gated adapter (igmoce_ir.py decoder); in training
    ``(x, aux)``."""

    def __init__(self, dim: int, num_heads: int, expansion: int = 2,
                 use_bias: bool = False, ln_type: str = "HolisticWithBias",
                 dtype=None, **adapter_kw):
        super().__init__()
        self.norms = nn.ModuleList([LN(dim, ln_type), LN(dim, ln_type)])
        self.proj = nn.ModuleList([Conv(dim, dim, 1, bias=True, dtype=dtype),
                                   Conv(dim, dim, 1, bias=True, dtype=dtype)])
        self.shared = SpAM(dim, 2, (1, 2, 4), dtype=dtype)
        self.adapter = IGAdapterLayer(dim, dtype=dtype, **adapter_kw)
        self.mixer = ChannelCrossAttention(dim, num_heads, use_bias,
                                           dtype=dtype, kv_kernel=7)
        self.ffn = GDFN(dim, expansion, use_bias, dtype=dtype)

    def forward(self, x, train=False, generator=None):
        xn = self.norms[0](x)
        x_s = self.shared(self.proj[0](xn))
        x_a = self.adapter(self.proj[1](xn), x_s, train, generator)
        if train:
            x_a, aux = x_a
        x = self.mixer(x_a, x_s) + x
        x = x + self.ffn(self.norms[1](x))
        return (x, aux) if train else x


def igmoce_key_map(key: str):
    """Reference torch key -> this model's key: the ``.layers.`` level
    flattened and BasicConv's ``main`` Sequential skipped; None for the
    routing ``complexity`` buffer and the unused ``freq_gate`` (the JAX
    ``igmoce_key_map``)."""
    if key.endswith("routing.complexity") or ".routing.freq_gate." in key:
        return None
    return key.replace(".layers.", ".").replace(".main.0.", ".")


@register_model("igmoce_ir", key_map=igmoce_key_map)
class IGMoCEIR(nn.Module):
    """igmoce_ir.py:1008-1142. Takes and returns NCHW; the output is fp32,
    and ``(out, {"aux_loss": ...})`` with ``train`` (MoCE-IR's
    ``forward``). H and W must be multiples of 2^(levels-1).
    ``with_complexity`` and ``complexity_scale`` set the complexity bias
    of training's importance loss; ``depth_type`` and ``stage_depth``
    change nothing."""

    uses_moe_rng = True

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 dim: int = 32, levels: int = 4,
                 heads: Sequence[int] = (1, 1, 1, 1),
                 num_blocks: Sequence[int] = (1, 1, 1, 3),
                 num_dec_blocks: Sequence[int] = (1, 1, 1),
                 ffn_expansion_factor: int = 2,
                 ln_type: str = "HolisticWithBias", dw_expand: int = 2,
                 dilations: Sequence[int] = (1, 4, 9),
                 fusion_weight: float = 0.5, use_bias: bool = False,
                 rank: int = 2, num_experts: int = 4, depth_type: Any = "lin",
                 stage_depth: Sequence[int] = (3, 2, 1),
                 rank_type: str = "constant", topk: int = 1,
                 with_complexity: bool = False, complexity_scale: str = "max",
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.num_dec_total = sum(num_dec_blocks)
        d = dim
        dims = [d * 2 ** i for i in range(levels)]
        enc = dict(expansion=ffn_expansion_factor, use_bias=True,
                   ln_type=ln_type, dw_expand=dw_expand, dilations=dilations,
                   fusion_weight=fusion_weight, dtype=dtype)

        def stack(c, h, n):
            return nn.ModuleList(IGEncoderBlock(c, h, **enc) for _ in range(n))

        self.estimator = IlluminationEstimator(d, dtype=dtype)
        self.illu_patch_embed = Conv(3, d // 2, 3, padding=1, bias=True,
                                     dtype=dtype)
        self.patch_embed = Conv(in_channels, d, 3, padding=1, bias=False,
                                dtype=dtype)
        self.enc = nn.ModuleList(
            nn.ModuleList([stack(dims[i], heads[i], num_blocks[i]),
                           Downsample(dims[i], dtype)])
            for i in range(levels - 1))
        self.illu_downsamples = nn.ModuleList(
            Downsample(d // 2 * 2 ** i, dtype) for i in range(levels - 1))
        self.latent = stack(dims[-1], heads[-1], num_blocks[-1])
        rdims, rheads = dims[::-1], list(heads)[::-1]
        rdec = list(num_dec_blocks)[::-1]
        self.dec = nn.ModuleList(
            nn.ModuleList([
                Upsample(rdims[i], dtype),
                Conv(rdims[i], rdims[i + 1], 1, bias=use_bias, dtype=dtype),
                nn.ModuleList(
                    IGDecoderBlock(
                        rdims[i + 1], rheads[i + 1], ffn_expansion_factor,
                        use_bias, ln_type, dtype, rank=rank,
                        num_experts=num_experts, top_k=topk,
                        rank_type=rank_type, with_complexity=with_complexity,
                        complexity_scale=complexity_scale)
                    for _ in range(rdec[i]))])
            for i in range(levels - 1))
        self.output = Conv(d, out_channels, 3, padding=1, bias=use_bias,
                           dtype=dtype)

    def forward(self, img, train=False, generator=None):
        x = img if self.dtype is None else img.to(self.dtype)
        _, illu_map = self.estimator(x)
        illu_fea = self.illu_patch_embed(illu_map)
        x = x * illu_map + x
        feats = self.patch_embed(x)
        skips = []
        for (blocks, down), illu_down in zip(self.enc, self.illu_downsamples):
            for blk in blocks:
                feats = blk(feats, illu_fea)
            skips.append(feats)
            feats = down(feats)
            illu_fea = illu_down(illu_fea)
        for blk in self.latent:
            feats = blk(feats, illu_fea)
        total_aux = 0.0
        for up, reduce, blocks in self.dec:
            feats = reduce(torch.cat([up(feats), skips.pop()], dim=1))
            for blk in blocks:
                if train:
                    feats, aux = blk(feats, True, generator)
                    total_aux = total_aux + aux
                else:
                    feats = blk(feats)
        out = self.output(feats)
        out = (out + img.to(out.dtype)).float()
        if train:
            return out, {"aux_loss": total_aux / self.num_dec_total}
        return out

