"""HierViG, the hierarchical gated-linear-attention backbone
(image_restoration_tpu/models/vig_h.py).

* :class:`GLA2D`: a 3x3 depthwise conv (+SiLU) whose output is the local
  branch and the input of every projection, the fused qkv and low-rank
  gate projections, the bidirectional GLA scan (``ops/gla.py``) and the
  gated per-head RMSNorm blend (``models/vig.py`` ``gla_mix``). The scan is
  halved, the reference's train path (its eval path double-counts).
* :class:`VSSBlock`: LayerNorm, GLA2D, residual, LayerNorm, MLP (GELU, or
  a SwiGLU whose width rounds to 32 with ``gmlp``), residual.
* :class:`PatchMerging2D` (downsample ``v1``) or a stride-2 conv of 2x2
  (``v2``) or 3x3 (``v3``) with a LayerNorm between stages; the v1 (one
  conv) or v2 (two convs, GELU between) patch embed; a LayerNorm, the mean
  over the map and a linear classifier.

Blocks run on channels-last maps (B, H, W, C), the reference's
``channel_first=False`` layout; the model takes NCHW images. Attribute
names are the reference torch model's (``patch_embed.0``,
``layers.0.blocks.1.op.qkv_proj``, ``layers.0.downsample.1``,
``classifier.head``); :func:`vig_h_key_map` maps them to the JAX tree.

Parameters stay fp32; ``dtype`` is the compute dtype of every conv and
dense layer. Every LayerNorm is flax's with ``dtype=None``
(``PromotingLayerNorm``): it returns fp32, so in a bf16 model the
residual stream is fp32 from the patch embed on, and only the logits are
bf16 again.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.models.vig import RMSNorm, gla_mix, rope_2dv1
from image_restoration_tpu_torch.ops.common import Conv, Linear, gelu_exact
from image_restoration_tpu_torch.ops.layernorm import PromotingLayerNorm


def vig_h_key_map(key: str) -> str:
    """Reference torch key -> the key the JAX importer walks
    (tests/test_vig_h_parity.py): the stage and block indices and the
    patch embed, downsample, classifier and MLP levels join their
    parents."""
    key = key.replace("patch_embed.", "patch_embed_")
    key = re.sub(r"layers\.(\d+)\.blocks\.(\d+)\.", r"layers_\1_blocks_\2.",
                 key)
    key = re.sub(r"layers\.(\d+)\.downsample\.", r"layers_\1_downsample.",
                 key)
    key = key.replace("classifier.norm.", "classifier_norm.")
    key = key.replace("classifier.head.", "classifier_head.")
    return key.replace(".mlp.fc1.", ".mlp_fc1.").replace(".mlp.fc2.",
                                                         ".mlp_fc2.")


def _conv_nhwc(conv, x):
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _indexed(**modules):
    """A container whose children are named by the reference's Sequential
    indices (the permutes and activations between them hold no weights)."""
    return nn.Sequential(OrderedDict(modules))


class GLA2D(nn.Module):
    """GLA over the H x W map of x (B, H, W, C)."""

    def __init__(self, d_model: int, num_heads: int = 4,
                 expand_k: float = 0.5, expand_v: float = 1.0,
                 gate_low_rank_dim: int = 16, gate_logit_normalizer: int = 16,
                 norm_eps: float = 1e-6, rope_mode: str = "none",
                 use_act_in_conv: bool = True, dtype=None):
        super().__init__()
        self.key_dim = int(d_model * expand_k)
        self.value_dim = int(d_model * expand_v)
        self.num_heads = num_heads
        self.hk = self.key_dim // num_heads
        self.hv = self.value_dim // num_heads
        self.normalizer = gate_logit_normalizer
        self.rope_mode = rope_mode
        self.use_act_in_conv = use_act_in_conv
        c = d_model
        self.in_proj = nn.Sequential(Conv(c, c, 3, padding=1, groups=c,
                                          bias=False, dtype=dtype))
        self.qkv_proj = Linear(c, 2 * self.key_dim + self.value_dim,
                               bias=False, dtype=dtype)
        self.gk_proj = nn.Sequential(
            Linear(c, gate_low_rank_dim, bias=False, dtype=dtype),
            Linear(gate_low_rank_dim, 2 * self.key_dim, dtype=dtype))
        self.g_proj = Linear(c, self.value_dim, dtype=dtype)
        self.g_norm = RMSNorm(self.hv, norm_eps)
        self.l_norm = RMSNorm(c // num_heads, norm_eps)
        self.o_proj = Linear(self.value_dim, d_model, bias=False, dtype=dtype)

    def forward(self, x):
        b, h, w, c = x.shape
        conv = _conv_nhwc(self.in_proj[0], x)
        if self.use_act_in_conv:
            conv = F.silu(conv)
        xs = conv.reshape(b, h * w, c)
        q, k, v = self.qkv_proj(xs).split(
            [self.key_dim, self.key_dim, self.value_dim], dim=-1)
        fw_gk, bw_gk = self.gk_proj(xs).chunk(2, dim=-1)
        rope = None
        if self.rope_mode == "2dv1":
            def rope(t):
                return rope_2dv1(t, h, w, self.hk)
        o = gla_mix(xs, q, k, v, fw_gk, bw_gk, self.num_heads, self.hk,
                    self.hv, (self.g_norm, self.l_norm), self.g_proj,
                    self.normalizer, rope=rope)
        return self.o_proj(o).reshape(b, h, w, -1)


class Mlp(nn.Module):
    """fc1, GELU (exact), fc2; with ``gated`` a bias-free SwiGLU, its
    hidden width 8/3 x rounded up to 32."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, gated: bool = False,
                 dtype=None):
        super().__init__()
        self.gated = gated
        if gated:
            inter = int(dim * 4 * 2 / 3)
            inter = 32 * ((inter + 31) // 32)
            self.fc1 = Linear(dim, inter * 2, bias=False, dtype=dtype)
            self.fc2 = Linear(inter, dim, bias=False, dtype=dtype)
        else:
            hidden = int(dim * mlp_ratio)
            self.fc1 = Linear(dim, hidden, dtype=dtype)
            self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        if self.gated:
            gate, y = self.fc1(x).chunk(2, dim=-1)
            return self.fc2(F.silu(gate) * y)
        return self.fc2(gelu_exact(self.fc1(x)))


class VSSBlock(nn.Module):
    """x + GLA2D(LN(x)), then + MLP(LN(.)), on (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int, expand_k: float = 0.5,
                 expand_v: float = 1.0, rope_mode: str = "none",
                 mlp_ratio: float = 4.0, gmlp: bool = False, dtype=None):
        super().__init__()
        self.norm = PromotingLayerNorm(dim)
        self.op = GLA2D(dim, num_heads, expand_k, expand_v,
                        rope_mode=rope_mode, dtype=dtype)
        self.norm2 = PromotingLayerNorm(dim)
        self.mlp = Mlp(dim, mlp_ratio, gmlp, dtype=dtype)

    def forward(self, x):
        x = x + self.op(self.norm(x))
        return x + self.mlp(self.norm2(x))


class PatchMerging2D(nn.Module):
    """Each 2x2 patch's four pixels side by side in the channels, in the
    order (0, 0), (1, 0), (0, 1), (1, 1) (row, column); a LayerNorm; a
    bias-free linear map to ``out_dim`` (2 dim by default). Odd sides are
    zero-padded at the end. (B, H, W, C) -> (B, H/2, W/2, out)."""

    def __init__(self, dim: int, out_dim: int = -1, dtype=None):
        super().__init__()
        self.norm = PromotingLayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, out_dim if out_dim > 0 else 2 * dim,
                                bias=False, dtype=dtype)

    def forward(self, x):
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class Stage(nn.Module):
    """A stage's blocks and the downsample that follows it (none after the
    last)."""

    def __init__(self, blocks, downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        if isinstance(self.downsample, PatchMerging2D):
            return self.downsample(x)
        if self.downsample is not None:  # conv "1", LayerNorm "3"
            conv, norm = self.downsample
            return norm(_conv_nhwc(conv, x))
        return x


@register_model("vig_h", key_map=vig_h_key_map)
class HierViG(nn.Module):
    """HierViG on NCHW images: logits (B, num_classes) in the compute
    dtype, or the pooled fp32 feature when ``num_classes`` is 0. Defaults
    are the JAX model's: depths 2/2/9/2, dims 96-768, heads 3-24, patch 4,
    downsample v2, patch embed v1."""

    def __init__(self, patch_size: int = 4, num_classes: int = 1000,
                 depths: Sequence[int] = (2, 2, 9, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 expand_k: float = 0.5, expand_v: float = 1.0,
                 rope_mode: str = "none", mlp_ratio: float = 4.0,
                 gmlp: bool = False, downsample_version: str = "v2",
                 patchembed_version: str = "v1", in_chans: int = 3,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.patchembed_version = patchembed_version
        d0 = dims[0]
        if patchembed_version == "v1":
            self.patch_embed = _indexed(**{
                "0": Conv(in_chans, d0, patch_size, patch_size, dtype=dtype),
                "2": PromotingLayerNorm(d0)})
        else:
            s = patch_size // 2
            self.patch_embed = _indexed(**{
                "0": Conv(in_chans, d0 // 2, s + 1, s, 1, dtype=dtype),
                "2": PromotingLayerNorm(d0 // 2),
                "5": Conv(d0 // 2, d0, s + 1, s, 1, dtype=dtype),
                "7": PromotingLayerNorm(d0)})
        stages = []
        for li, depth in enumerate(depths):
            blocks = [VSSBlock(dims[li], num_heads[li], expand_k, expand_v,
                               rope_mode, mlp_ratio, gmlp, dtype=dtype)
                      for _ in range(depth)]
            down = None
            if li < len(depths) - 1:
                if downsample_version == "v1":
                    down = PatchMerging2D(dims[li], dims[li + 1], dtype=dtype)
                else:
                    k, p = (2, 0) if downsample_version == "v2" else (3, 1)
                    down = _indexed(**{
                        "1": Conv(dims[li], dims[li + 1], k, 2, p,
                                  dtype=dtype),
                        "3": PromotingLayerNorm(dims[li + 1])})
            stages.append(Stage(blocks, down))
        self.layers = nn.ModuleList(stages)
        self.classifier = nn.Module()
        self.classifier.norm = PromotingLayerNorm(dims[-1])
        self.classifier.head = (Linear(dims[-1], num_classes, dtype=dtype)
                                if num_classes > 0 else nn.Identity())

    def forward(self, x):
        pe = self.patch_embed
        x = pe[1](pe[0](x).permute(0, 2, 3, 1))
        if self.patchembed_version != "v1":
            x = pe[3](_conv_nhwc(pe[2], gelu_exact(x)))
        for stage in self.layers:
            x = stage(x)
        return self.classifier.head(self.classifier.norm(x).mean((1, 2)))
