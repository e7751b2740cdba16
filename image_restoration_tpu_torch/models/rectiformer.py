"""RectiFormer (experiment/RectiFormer.py; image_restoration_tpu/models/
rectiformer.py), NCHW: a prompt-modulated, asymmetric Restormer U-Net.

* :class:`MSDRNet` (:63-108): three strided stems of kernel 2s+1, a 1x1
  fusion and a global average pool, then an MLP (Dense, flax LayerNorm,
  exact GELU, Dense) into the degradation vector and one prompt per level.
* :class:`MDPM` (:111-146): the prompt's channel affine (1 + gamma, beta),
  a spatial map from the prompt-scaled feature and a dynamic attention
  temperature 2 sigmoid(.).
* :class:`ElementwiseGatedAttention` (:270-325): MDTA whose temperature is
  scaled per sample by the dynamic one and whose output is gated by a
  depthwise-then-1x1 sigmoid branch.
* :class:`GatedSpatialFFN` (:231-266): a sigmoid gate from one depthwise
  conv times exact-GELU content from the other.
* :class:`DGSB` bottleneck (:154-228): an fp32 rfft2 split by a Gaussian
  mask into low and high bands, each through an fp32 1x1 conv and back, a
  depthwise spatial branch, and a softmax 3-way fusion from the
  degradation vector. The mask is centred at (f_h // 2, f_w // 2) of the
  unshifted rfft2 grid, as the reference computes it, with a width of
  h // 8 of the latent's height: below 64x64 inputs that is 0, and the
  output is NaN, in the reference, in JAX and here.

The blocks are not Restormer blocks (their attention and FFN differ), and
JAX runs them as plain XLA: plain torch here. Parameters stay fp32 and
``dtype`` is the compute dtype, with the fp32 islands where JAX has them
(the prompt MLP's LayerNorm, the frequency branch). Attribute paths are
the reference's (``encoder_level1.0.prompt_fusion.channel_proj.weight``,
``context_net.global_process.3.weight``), which ``utils/jax_bridge.py``
maps onto the JAX tree without a key map.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from image_restoration_tpu_torch.models.moce_ir import gap
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.attention import mdta_attention
from image_restoration_tpu_torch.ops.common import Conv, Linear, gelu_exact
from image_restoration_tpu_torch.ops.fft import irfft2, rfft2
from image_restoration_tpu_torch.ops.layernorm import (
    LayerNorm, PromotingLayerNorm,
)
from image_restoration_tpu_torch.ops.resample import Downsample, Upsample


class MSDRNet(nn.Module):
    """MSDRNet_NoModal: returns (prompts, one per ``dim_list`` entry, and
    the (B, context_dim) degradation vector), in the compute dtype."""

    def __init__(self, inp_channels: int = 3, context_dim: int = 64,
                 num_scales: int = 3,
                 dim_list: Sequence[int] = (48, 96, 192, 384), dtype=None):
        super().__init__()
        self.scale_convs = nn.ModuleList(
            Conv(inp_channels, 16, 2 * s + 1, stride=2, padding=s,
                 dtype=dtype) for s in range(num_scales))
        self.fusion = Conv(16 * num_scales, context_dim, 1, dtype=dtype)
        self.global_process = nn.Sequential(
            Linear(context_dim, context_dim * 2, dtype=dtype),
            PromotingLayerNorm(context_dim * 2), nn.GELU(),
            Linear(context_dim * 2, context_dim, dtype=dtype))
        self.layer_prompts = nn.ModuleList(
            Linear(context_dim, d, dtype=dtype) for d in dim_list)

    def forward(self, x):
        feat = self.fusion(torch.cat([c(x) for c in self.scale_convs], 1))
        g = self.global_process(gap(feat))
        return [p(g) for p in self.layer_prompts], g


class MDPM(nn.Module):
    """Prompt modulation: (x modulated, the (B, 1, 1, 1) dynamic
    temperature)."""

    def __init__(self, dim: int, context_dim: int, dtype=None):
        super().__init__()
        self.channel_proj = Linear(context_dim, dim * 2, dtype=dtype)
        self.spatial_proj = Linear(context_dim, dim, dtype=dtype)
        self.spatial_conv = Conv(dim, 1, 3, padding=1, dtype=dtype)
        self.temp_proj = Linear(context_dim, 1, dtype=dtype)

    def forward(self, x, context_emb):
        gamma, beta = self.channel_proj(context_emb).chunk(2, dim=-1)
        x = x * (1 + gamma[:, :, None, None]) + beta[:, :, None, None]
        s_feat = x * self.spatial_proj(context_emb)[:, :, None, None]
        x = x * self.spatial_conv(gelu_exact(s_feat))
        dyn = torch.sigmoid(self.temp_proj(context_emb)[:, 0]) * 2.0
        return x, dyn[:, None, None, None]


class ElementwiseGatedAttention(nn.Module):
    """MDTA with the temperature ``temperature x dynamic_temp`` (fp32, per
    sample) and the output times sigmoid(1x1(depthwise 3x3(x))) before
    ``project_out``."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False,
                 dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv(dim, dim * 3, 1, bias=bias, dtype=dtype)
        self.qkv_dwconv = Conv(dim * 3, dim * 3, 3, padding=1,
                               groups=dim * 3, bias=bias, dtype=dtype)
        self.gate_generator = nn.Sequential(
            Conv(dim, dim, 3, padding=1, groups=dim, bias=bias, dtype=dtype),
            Conv(dim, dim, 1, bias=bias, dtype=dtype))
        self.project_out = Conv(dim, dim, 1, bias=bias, dtype=dtype)

    def forward(self, x, dynamic_temp=None):
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        gate = self.gate_generator(x)
        temp = self.temperature[None].float()
        if dynamic_temp is not None:  # (B, heads, 1, 1), promoted to fp32
            temp = temp * dynamic_temp.float()
        out = mdta_attention(q, k, v, temp, self.num_heads)
        return self.project_out(out * torch.sigmoid(gate))


class GatedSpatialFFN(nn.Module):
    """1x1 to 2 hidden; sigmoid(depthwise(gate half)) x GELU(depthwise
    (content half)); 1x1 back, with ``hidden = int(dim * expansion)``."""

    def __init__(self, dim: int, expansion: float = 2.66, bias: bool = False,
                 dtype=None):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = Conv(dim, hidden * 2, 1, bias=bias, dtype=dtype)
        self.dwconv_gate = Conv(hidden, hidden, 3, padding=1, groups=hidden,
                                bias=bias, dtype=dtype)
        self.dwconv_content = Conv(hidden, hidden, 3, padding=1,
                                   groups=hidden, bias=bias, dtype=dtype)
        self.project_out = Conv(hidden, dim, 1, bias=bias, dtype=dtype)

    def forward(self, x):
        content, gate = self.project_in(x).chunk(2, dim=1)
        gate = torch.sigmoid(self.dwconv_gate(gate))
        content = gelu_exact(self.dwconv_content(content))
        return self.project_out(content * gate)


def _gaussian_mask(h, w):
    """The low band's mask over the (h, w // 2 + 1) rfft2 grid of an h x w
    map (rectiformer.py:177-183): exp(-d^2 / (2 (h // 8)^2)) with d the
    distance to (f_h // 2, f_w // 2), in float64, NaN at the centre and 0
    elsewhere when h // 8 is 0, as the reference's torch division gives."""
    fh, fw = h, w // 2 + 1
    yy, xx = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
    dist2 = (xx - fw // 2) ** 2 + (yy - fh // 2) ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.exp(-dist2 / (2.0 * (h // 8) ** 2))


# (h, w, device) -> fp32 mask: built once, as a host-to-device copy blocks
# the host
_MASKS = {}


def gaussian_mask(h, w, device):
    """:func:`_gaussian_mask` as an fp32 (h, w // 2 + 1) tensor on
    ``device``, cached; a normal tensor even when first built under
    ``torch.inference_mode``, so a later differentiated forward can read
    it."""
    key = (h, w, torch.device(device))
    if key not in _MASKS:
        with torch.inference_mode(False):
            _MASKS[key] = torch.from_numpy(_gaussian_mask(h, w)).float().to(
                device)
    return _MASKS[key]


class DGSB(nn.Module):
    """Degradation-guided frequency selection bottleneck: (the low band,
    the high band, the spatial branch) fused by softmax weights from the
    degradation vector, a 1x1, plus the input."""

    def __init__(self, dim: int, context_dim: int = 64, dtype=None):
        super().__init__()
        self.spatial_conv = nn.Sequential(
            Conv(dim, dim, 3, padding=1, groups=dim, dtype=dtype),
            Conv(dim, dim, 1, dtype=dtype))
        f32 = torch.float32
        self.low_freq_conv = Conv(2 * dim, 2 * dim, 1, dtype=f32)
        self.high_freq_conv = Conv(2 * dim, 2 * dim, 1, dtype=f32)
        self.fusion_proj = Linear(context_dim, 3, dtype=dtype)
        self.fusion = Conv(3 * dim, dim, 1, dtype=dtype)

    def forward(self, x, global_feat):
        h, w = x.shape[-2:]
        spatial = self.spatial_conv(x)
        z = rfft2(x)
        cat = torch.cat([z.real, z.imag], dim=1)
        low_mask = gaussian_mask(h, w, x.device)

        def band(conv, mask):
            r, i = conv(cat * mask).chunk(2, dim=1)
            return irfft2(torch.complex(r, i), (h, w), dtype=x.dtype)

        low_s = band(self.low_freq_conv, low_mask)
        high_s = band(self.high_freq_conv, 1 - low_mask)
        wts = torch.softmax(self.fusion_proj(global_feat), dim=-1)
        lw, hw, sw = (wts[:, i, None, None, None] for i in range(3))
        fused = torch.cat([low_s * lw, high_s * hw, spatial * sw], dim=1)
        return self.fusion(fused) + x


class DynamicTransformerBlock(nn.Module):
    """LN -> MDPM(prompt) -> gated attention -> +res; LN -> gated FFN ->
    +res (RectiFormer.py:329-358)."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 bias: bool = False, ln_type: str = "WithBias", dtype=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, ln_type)
        self.prompt_fusion = MDPM(dim, dim, dtype)
        self.attn = ElementwiseGatedAttention(dim, num_heads, bias, dtype)
        self.norm2 = LayerNorm(dim, ln_type)
        self.ffn = GatedSpatialFFN(dim, expansion, bias, dtype)

    def forward(self, x, prompt):
        h, dyn = self.prompt_fusion(self.norm1(x), prompt)
        x = x + self.attn(h, dyn)
        return x + self.ffn(self.norm2(x))


@register_model("rectiformer")
class RectiFormer(nn.Module):
    """RectiFormer.py:396-603: encoder levels of 4/6/6/8 blocks, the DGSB
    bottleneck, decoder levels of 2/3/3 blocks (the fourth count is
    unused, as in the reference) with 1x1 skip reductions at every level,
    4 refinement blocks; level i's blocks read prompt p_i. Takes NCHW and
    returns the fp32 restoration, the input plus the network's output."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48,
                 num_encoder_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_decoder_blocks: Sequence[int] = (2, 3, 3, 4),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, use_bias: bool = False,
                 ln_type: str = "WithBias", context_dim: int = 64,
                 num_scales: int = 3, dtype=None):
        super().__init__()
        self.dtype = dtype
        dims = [dim * 2 ** i for i in range(4)]

        def blocks(level, n):
            return nn.ModuleList(
                DynamicTransformerBlock(dims[level], heads[level],
                                        ffn_expansion_factor, use_bias,
                                        ln_type, dtype) for _ in range(n))

        self.context_net = MSDRNet(inp_channels, context_dim, num_scales,
                                   dims, dtype)
        self.patch_embed = Conv(inp_channels, dim, 3, padding=1, bias=False,
                                dtype=dtype)
        for i in range(4):
            setattr(self, f"encoder_level{i + 1}",
                    blocks(i, num_encoder_blocks[i]))
        for i in range(3):
            setattr(self, f"down{i + 1}_{i + 2}", Downsample(dims[i], dtype))
        self.freq_fusion = DGSB(dims[3], context_dim, dtype)
        for i in (3, 2, 1):
            setattr(self, f"up{i + 1}_{i}", Upsample(dims[i], dtype))
            setattr(self, f"reduce_chan_level{i}",
                    Conv(dims[i], dims[i - 1], 1, bias=use_bias,
                         dtype=dtype))
            setattr(self, f"decoder_level{i}",
                    blocks(i - 1, num_decoder_blocks[i - 1]))
        self.refinement = blocks(0, num_refinement_blocks)
        self.output = Conv(dim, out_channels, 3, padding=1, bias=use_bias,
                           dtype=dtype)

    @staticmethod
    def _run(stack, x, prompt):
        for blk in stack:
            x = blk(x, prompt)
        return x

    def forward(self, inp_img):
        x = inp_img if self.dtype is None else inp_img.to(self.dtype)
        prompts, gfeat = self.context_net(x)
        enc = [self._run(self.encoder_level1, self.patch_embed(x),
                         prompts[0])]
        for i in range(1, 4):
            down = getattr(self, f"down{i}_{i + 1}")
            enc.append(self._run(getattr(self, f"encoder_level{i + 1}"),
                                 down(enc[-1]), prompts[i]))
        dec = self.freq_fusion(enc[3], gfeat)
        for i in (3, 2, 1):
            dec = getattr(self, f"up{i + 1}_{i}")(dec)
            dec = getattr(self, f"reduce_chan_level{i}")(
                torch.cat([dec, enc[i - 1]], dim=1))
            dec = self._run(getattr(self, f"decoder_level{i}"), dec,
                            prompts[i - 1])
        dec = self._run(self.refinement, dec, prompts[0])
        return (self.output(dec) + x).float()
