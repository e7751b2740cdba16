"""LumiSenseMoE (LumiSenseMoE/src/net/LimiSenseMoE.py;
image_restoration_tpu/models/lumisense_moe.py), NCHW.

MoCE-IR's decoder (frequency-gated complexity experts, an MDTA shared
branch, the cross-attention mixer) under an illumination-guided encoder:
the estimator (grouped conv with groups = its width, unlike IGMoCE-IR's
4) modulates the input, x * illu_map + x, and its features scale V in
every encoder block (``IGMSASimple``). The blocks keep the reference's
normed shortcut (x = norm(x); x = x + mixer(x)). The illumination stream
shares the feature maps' Downsample and Upsample modules. The input is
zero-padded to 2^levels, and the residual goes to the padded image.
Plain torch throughout (plain XLA in JAX); eval only, as MoCE-IR.
Attribute paths follow the JAX tree; :func:`lumisense_key_map` maps a
reference state_dict onto them.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from image_restoration_tpu_torch.models.moce_ir import (
    DecoderBlock,
    FrequencyEmbedding,
    _zero_pad_to,
    moce_key_map,
)
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.attention import mdta_attention
from image_restoration_tpu_torch.ops.common import Conv
from image_restoration_tpu_torch.ops.ffn import GDFN
from image_restoration_tpu_torch.ops.illumination import IlluminationEstimator
from image_restoration_tpu_torch.ops.layernorm import LayerNorm
from image_restoration_tpu_torch.ops.resample import Downsample, Upsample


class IGMSASimple(nn.Module):
    """MDTA whose V is scaled by the illumination features
    (LimiSenseMoE.py:233-280)."""

    def __init__(self, dim: int, num_heads: int, use_bias: bool = False,
                 dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv(dim, dim * 3, 1, bias=use_bias, dtype=dtype)
        self.qkv_dwconv = Conv(dim * 3, dim * 3, 3, padding=1,
                               groups=dim * 3, bias=use_bias, dtype=dtype)
        self.project_out = Conv(dim, dim, 1, bias=use_bias, dtype=dtype)

    def forward(self, x, illu_fea):
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        out = mdta_attention(q, k, v * illu_fea, self.temperature,
                             self.num_heads)
        return self.project_out(out)


class LumiEncoderBlock(nn.Module):
    """The normed-shortcut pre-norm block (LimiSenseMoE.py:283-300):
    x = LN(x); x += IGMSASimple(x); x = LN(x); x += GDFN(x)."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.0,
                 use_bias: bool = True, ln_type: str = "WithBias",
                 dtype=None):
        super().__init__()
        self.norms = nn.ModuleList([LayerNorm(dim, ln_type),
                                    LayerNorm(dim, ln_type)])
        self.mixer = IGMSASimple(dim, num_heads, use_bias, dtype)
        self.ffn = GDFN(dim, expansion, use_bias, dtype=dtype)

    def forward(self, x, illu_fea):
        x = self.norms[0](x)
        x = x + self.mixer(x, illu_fea)
        x = self.norms[1](x)
        return x + self.ffn(x)


# The reference's decoder block is the original MoCE one
# (LimiSenseMoE.py:747-797).
LumiDecoderBlock = DecoderBlock


# Reference torch key -> this model's key: MoCE-IR's map, as the JAX
# ``lumisense_key_map`` is.
lumisense_key_map = moce_key_map


@register_model("lumisense_moe", key_map=lumisense_key_map)
class LumiSenseMoEIR(nn.Module):
    """LimiSenseMoE.py:833-1003. Takes and returns NCHW; the output is
    fp32. Refinement blocks run at heads[0] (the reference reverses
    ``heads`` twice before them). ``depth_type``, ``stage_depth``,
    ``with_complexity`` and ``complexity_scale`` set the complexity
    statistic of training and change nothing in eval."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 32, levels: int = 4,
                 heads: Sequence[int] = (1, 1, 1, 1),
                 num_blocks: Sequence[int] = (1, 1, 1, 3),
                 num_dec_blocks: Sequence[int] = (1, 1, 1),
                 ffn_expansion_factor: float = 2.0,
                 num_refinement_blocks: int = 1, ln_type: str = "WithBias",
                 use_bias: bool = False, rank: int = 2, num_experts: int = 4,
                 depth_type: Any = "lin",
                 stage_depth: Sequence[int] = (3, 2, 1),
                 rank_type: str = "constant", topk: int = 1,
                 with_complexity: bool = False, complexity_scale: str = "max",
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.levels = levels
        d = dim
        dims = [d * 2 ** i for i in range(levels)]

        def stack(c, h, n):
            return nn.ModuleList(
                LumiEncoderBlock(c, h, ffn_expansion_factor, True, ln_type,
                                 dtype) for _ in range(n))

        self.estimator = IlluminationEstimator(d, depth_groups=d, dtype=dtype)
        self.embedding = Conv(inp_channels, d, 3, padding=1, bias=False,
                              dtype=dtype)
        self.enc = nn.ModuleList(
            nn.ModuleList([stack(dims[i], heads[i], num_blocks[i]),
                           Downsample(dims[i], dtype)])
            for i in range(levels - 1))
        self.latent = stack(dims[-1], heads[-1], num_blocks[-1])
        self.freq_embed = FrequencyEmbedding(dims[-1], dtype)
        rdims, rheads = dims[::-1], list(heads)[::-1]
        rdec = list(num_dec_blocks)[::-1]
        self.dec = nn.ModuleList(
            nn.ModuleList([
                Upsample(rdims[i], dtype),
                Conv(rdims[i], rdims[i + 1], 1, bias=use_bias, dtype=dtype),
                nn.ModuleList(
                    LumiDecoderBlock(
                        rdims[i + 1], rheads[i + 1], ffn_expansion_factor,
                        use_bias, ln_type, dtype, rank=rank,
                        num_experts=num_experts, top_k=topk,
                        rank_type=rank_type, freq_dim=rdims[0])
                    for _ in range(rdec[i]))])
            for i in range(levels - 1))
        self.refinement = stack(d, heads[0], num_refinement_blocks)
        self.output = Conv(d, out_channels, 3, padding=1, bias=use_bias,
                           dtype=dtype)

    def forward(self, img):
        h, w = img.shape[-2:]
        img_p = _zero_pad_to(img, 2 ** self.levels)
        x = img_p if self.dtype is None else img_p.to(self.dtype)
        illu_fea, illu_map = self.estimator(x)
        x = x * illu_map + x
        feats = self.embedding(x)
        skips = []
        for blocks, down in self.enc:
            for blk in blocks:
                feats = blk(feats, illu_fea)
            skips.append(feats)
            feats, illu_fea = down(feats), down(illu_fea)
        for blk in self.latent:
            feats = blk(feats, illu_fea)
        freq_emb = self.freq_embed(feats)
        for up, reduce, blocks in self.dec:
            feats, illu_fea = up(feats), up(illu_fea)
            feats = reduce(torch.cat([feats, skips.pop()], dim=1))
            for blk in blocks:
                feats = blk(feats, freq_emb)
        for blk in self.refinement:
            feats = blk(feats, illu_fea)
        out = self.output(feats)
        return (out + img_p.to(out.dtype)).float()[..., :h, :w]
