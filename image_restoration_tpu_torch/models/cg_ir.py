"""DACG-IR (CG-IR): a Restormer U-Net whose blocks are conditioned on a
degradation context (image_restoration_tpu/models/cg_ir.py).

* ``DegradationAwareModule``: a multi-scale depthwise stem, a spatial gate,
  mean and std pooling into a global context vector, and one prompt per
  level;
* ``ContextAdaptiveGatedAttention``: MDTA whose per-head temperature is
  exp(learned log base + a context-predicted delta), per sample, and whose
  output passes a per-channel sigmoid gate predicted from the context
  before ``project_out``;
* ``CGDM``: dual-domain modulation after the latent level: rfft2 (fp32,
  ``norm="ortho"``), two fp32 1x1 convs over the [real; imag] channel
  blocks, a context sigmoid scale, irfft2, beside a spatial depthwise
  branch;
* ``AdaptiveGatedFusion``: a joint spatial and channel gate on each encoder
  skip before the fusion conv.

Parameters stay fp32 and ``dtype`` is the compute dtype, as in the JAX
model. With ``fused_block`` every CGTB runs as the two-kernel pair of
``kernels/block.py`` (K1, finalize, K2): the context's per-sample
temperature and the gate, both fp32 (the JAX ``_CGAttnParams``), go into
``finalize``, which folds the gate in as A^T diag(gate) W_proj. The plain
path takes the gate's sigmoid in the compute dtype and multiplies before
``project_out``, as the JAX ``ContextAdaptiveGatedAttention`` does; the two
paths round differently in bf16, as in JAX. The JAX ``scan_blocks`` is not
ported. Attribute paths follow the JAX tree, so ``utils/jax_bridge.py``
maps it onto this model.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from image_restoration_tpu_torch.kernels.block import (
    BlockParams, block_misfits, fused_block,
)
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.models.restormer import (
    OverlapPatchEmbed,
    _nhwc,
)
from image_restoration_tpu_torch.ops.attention import mdta_attention
from image_restoration_tpu_torch.ops.common import Conv, Linear
from image_restoration_tpu_torch.ops.ffn import GDFN
from image_restoration_tpu_torch.ops.layernorm import (
    GroupNorm,
    LayerNorm,
    WithBiasLayerNorm,
)
from image_restoration_tpu_torch.ops.resample import Downsample, Upsample


class DegradationAwareModule(nn.Module):
    """Image -> (one prompt per level, the global context vector)."""

    def __init__(self, context_dim: int = 64, num_scales: int = 3,
                 dim_list: Sequence[int] = (48, 96, 192, 384),
                 inp_channels: int = 3, dtype=None):
        super().__init__()
        inter = 48
        self.stem = nn.Sequential(
            Conv(inp_channels, inter, 3, padding=1, dtype=dtype), nn.GELU())
        self.scale_branches = nn.ModuleList(
            nn.Sequential(
                Conv(inter, inter, 2 * s + 3, padding=s + 1, groups=inter,
                     dtype=dtype),
                Conv(inter, inter, 1, dtype=dtype))
            for s in range(num_scales))
        self.fusion = Conv(inter * num_scales, context_dim, 1, dtype=dtype)
        self.spatial_gate = Conv(context_dim, 1, 1, dtype=dtype)
        self.global_process = nn.Sequential(
            Linear(2 * context_dim, context_dim, dtype=dtype),
            WithBiasLayerNorm(context_dim), nn.GELU(),
            Linear(context_dim, context_dim, dtype=dtype))
        self.layer_prompts = nn.ModuleList(
            Linear(context_dim, d, dtype=dtype) for d in dim_list)

    def forward(self, img):
        x = self.stem(img)
        feat = self.fusion(torch.cat([br(x) for br in self.scale_branches],
                                     dim=1))
        feat = feat * torch.sigmoid(self.spatial_gate(feat))
        avg = feat.mean(dim=(2, 3))
        std = feat.float().std(dim=(2, 3), correction=1).to(avg.dtype)
        g = self.global_process(torch.cat([avg, std], dim=-1))
        return [lp(g) for lp in self.layer_prompts], g


class AdaptiveGatedFusion(nn.Module):
    """Gate the encoder skip by a spatial x channel sigmoid predicted from
    [f_enc; f_dec], then fuse [gated f_enc; f_dec] with a 1x1 + GELU."""

    def __init__(self, in_dim: int, out_dim: int | None = None, dtype=None):
        super().__init__()
        d = in_dim
        self.spatial_gate = nn.Sequential(
            Conv(2 * d, d, 1, dtype=dtype),
            GroupNorm(min(8, d), d, eps=1e-5), nn.ReLU(),
            Conv(d, d, 3, padding=1, groups=d, dtype=dtype), nn.ReLU(),
            Conv(d, d, 1, dtype=dtype))
        self.channel_gate = nn.Sequential(
            Linear(2 * d, d // 2, dtype=dtype), nn.ReLU(),
            Linear(d // 2, d, dtype=dtype))
        self.fusion_conv = nn.Sequential(
            Conv(2 * d, out_dim or d, 1, dtype=dtype), nn.GELU())

    def forward(self, f_enc, f_dec):
        comb = torch.cat([f_enc, f_dec], dim=1)
        s = self.spatial_gate(comb)
        c = self.channel_gate(comb.mean(dim=(2, 3)))
        attn = torch.sigmoid(s + c[:, :, None, None])
        out = torch.cat([f_enc * attn, f_dec], dim=1)
        return self.fusion_conv(out)


class CGDM(nn.Module):
    """Context-gated dual-domain modulation of the latent, plus a residual.
    The FFTs and the frequency convs run in fp32; [real; imag] are channel
    blocks, not interleaved."""

    def __init__(self, dim: int, context_dim: int = 64, dtype=None):
        super().__init__()
        d = dim
        self.spatial_conv = nn.Sequential(
            Conv(d, d, 3, padding=1, groups=d, dtype=dtype), nn.GELU(),
            Conv(d, d, 1, dtype=dtype))
        self.freq_conv = nn.Sequential(
            Conv(2 * d, 2 * d, 1, dtype=torch.float32), nn.LeakyReLU(0.1),
            Conv(2 * d, 2 * d, 1, dtype=torch.float32))
        self.context_mapper = nn.Sequential(
            Linear(context_dim, d, dtype=dtype), nn.ReLU(),
            Linear(d, 2 * d, dtype=dtype))
        self.fusion = Conv(2 * d, d, 1, dtype=dtype)

    def forward(self, x, global_feat):
        h, w = x.shape[-2:]
        sp = self.spatial_conv(x)
        z = torch.fft.rfft2(x.float(), norm="ortho")
        f = torch.cat([z.real, z.imag], dim=1)
        f = self.freq_conv(f)
        scale = torch.sigmoid(self.context_mapper(global_feat).float())
        re, im = (f * scale[:, :, None, None]).chunk(2, dim=1)
        back = torch.fft.irfft2(torch.complex(re, im), s=(h, w), norm="ortho")
        out = self.fusion(torch.cat([sp, back.to(x.dtype)], dim=1))
        return out + x


class ContextAdaptiveGatedAttention(nn.Module):
    """MDTA with a per-sample temperature exp(log base + delta(context))
    and a per-channel sigmoid output gate from the context."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False,
                 context_dim: int = 64, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.log_base_temperature = nn.Parameter(torch.zeros(num_heads, 1, 1))
        self.temp_adapter = nn.Sequential(
            Linear(context_dim, dim // 4, dtype=dtype), nn.ReLU(),
            Linear(dim // 4, num_heads, dtype=dtype))
        self.attn_output_gate = nn.Sequential(
            Linear(context_dim, dim, dtype=dtype), nn.Sigmoid())
        self.qkv = Conv(dim, dim * 3, 1, bias=bias, dtype=dtype)
        self.qkv_dwconv = Conv(dim * 3, dim * 3, 3, padding=1,
                               groups=dim * 3, bias=bias, dtype=dtype)
        self.project_out = Conv(dim, dim, 1, bias=bias, dtype=dtype)

    def temperature(self, context_emb):
        """exp(log base + delta), fp32 (B, heads)."""
        delta = self.temp_adapter(context_emb)
        return torch.exp(self.log_base_temperature.reshape(1, -1).float()
                         + delta.float())

    def forward(self, x, context_emb):
        gate = self.attn_output_gate(context_emb)
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        out = mdta_attention(q, k, v, self.temperature(context_emb),
                             self.num_heads)
        return self.project_out(out * gate.to(x.dtype)[:, :, None, None])


class CGTB(nn.Module):
    """LN -> context-gated attention -> +res; LN -> GDFN -> +res. With
    ``fused_block`` the block runs as K1, finalize (per-sample temperature,
    gate folded in) and K2."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 use_bias: bool = False, ln_type: str = "WithBias",
                 context_dim: int = 64, fused_block: bool = False,
                 dtype=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.fused_block = fused_block
        self.norm1 = LayerNorm(dim, ln_type)
        self.attn = ContextAdaptiveGatedAttention(dim, num_heads, use_bias,
                                                  context_dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, ln_type)
        self.ffn = GDFN(dim, expansion, use_bias, dtype=dtype)

    def kernel_misfits(self) -> dict:
        """The kernel flags on that this block's width rules out."""
        return block_misfits(self.dim, self.num_heads, self.fused_block)

    def block_params(self, context_emb):
        """(BlockParams with the per-sample fp32 temperature (B, heads),
        the fp32 output gate (B, C)), as the JAX ``_CGAttnParams`` gives
        them."""
        n1, n2, at, ff = self.norm1.body, self.norm2.body, self.attn, self.ffn
        gate = torch.sigmoid(at.attn_output_gate[0](context_emb).float())
        p = BlockParams(
            n1.weight, getattr(n1, "bias", None),
            at.qkv.weight, at.qkv.bias, at.qkv_dwconv.weight,
            at.qkv_dwconv.bias, at.temperature(context_emb),
            at.project_out.weight, at.project_out.bias,
            n2.weight, getattr(n2, "bias", None),
            ff.project_in.weight, ff.project_in.bias, ff.dwconv.weight,
            ff.dwconv.bias, ff.project_out.weight, ff.project_out.bias)
        return p, gate

    def forward(self, x, context_emb):
        if self.fused_block:
            p, gate = self.block_params(context_emb)
            out = fused_block(_nhwc(x), p, self.num_heads, 1e-5, gate)
            return out.permute(0, 3, 1, 2)
        x = x + self.attn(self.norm1(x), context_emb)
        return x + self.ffn(self.norm2(x))


@register_model("cg_ir")
class DACG_IR(nn.Module):
    """Takes and returns NCHW; the output is fp32."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, use_bias: bool = False,
                 ln_type: str = "WithBias", context_dim: int = 64,
                 num_scales: int = 3, fused_block: bool = False, dtype=None):
        super().__init__()
        self.dtype = dtype
        dims = [dim * 2 ** i for i in range(4)]
        nb = num_blocks

        def stack(d, hd, n):
            return nn.ModuleList(
                CGTB(d, hd, ffn_expansion_factor, use_bias, ln_type, d,
                     fused_block=fused_block, dtype=dtype) for _ in range(n))

        self.context_net = DegradationAwareModule(
            context_dim, num_scales, dims, inp_channels, dtype=dtype)
        self.patch_embed = OverlapPatchEmbed(inp_channels, dims[0], dtype)
        self.encoder_level1 = stack(dims[0], heads[0], nb[0])
        self.down1_2 = Downsample(dims[0], dtype)
        self.encoder_level2 = stack(dims[1], heads[1], nb[1])
        self.down2_3 = Downsample(dims[1], dtype)
        self.encoder_level3 = stack(dims[2], heads[2], nb[2])
        self.down3_4 = Downsample(dims[2], dtype)
        self.latent = stack(dims[3], heads[3], nb[3])
        self.freq_fusion = CGDM(dims[3], context_dim, dtype=dtype)
        self.up4_3 = Upsample(dims[3], dtype)
        self.skip_fusion3 = AdaptiveGatedFusion(dims[2], dtype=dtype)
        self.decoder_level3 = stack(dims[2], heads[2], nb[2])
        self.up3_2 = Upsample(dims[2], dtype)
        self.skip_fusion2 = AdaptiveGatedFusion(dims[1], dtype=dtype)
        self.decoder_level2 = stack(dims[1], heads[1], nb[1])
        self.up2_1 = Upsample(dims[1], dtype)
        self.skip_fusion1 = AdaptiveGatedFusion(dims[0], dims[1], dtype=dtype)
        self.decoder_level1 = stack(dims[1], heads[0], nb[0])
        self.refinement = stack(dims[1], heads[0], num_refinement_blocks)
        self.output = Conv(dims[1], out_channels, 3, padding=1,
                           bias=use_bias, dtype=dtype)

    @staticmethod
    def _level(x, prompt, *stacks):
        # one layout change per level: the kernels read (B, H, W, C) views
        x = x.contiguous(memory_format=torch.channels_last)
        for stack in stacks:
            for blk in stack:
                x = blk(x, prompt)
        return x

    def forward(self, inp_img):
        x = inp_img if self.dtype is None else inp_img.to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        (p1, p2, p3, p4), gfeat = self.context_net(x)

        enc1 = self._level(self.patch_embed(x), p1, self.encoder_level1)
        enc2 = self._level(self.down1_2(enc1), p2, self.encoder_level2)
        enc3 = self._level(self.down2_3(enc2), p3, self.encoder_level3)
        latent = self._level(self.down3_4(enc3), p4, self.latent)
        latent = self.freq_fusion(latent, gfeat)

        dec3 = self.skip_fusion3(enc3, self.up4_3(latent))
        dec3 = self._level(dec3, p3, self.decoder_level3)
        dec2 = self.skip_fusion2(enc2, self.up3_2(dec3))
        dec2 = self._level(dec2, p2, self.decoder_level2)
        dec1 = self.skip_fusion1(enc1, self.up2_1(dec2))
        dec1 = self._level(dec1, p2, self.decoder_level1, self.refinement)
        return (self.output(dec1) + x).float()
