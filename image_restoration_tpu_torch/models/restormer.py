"""Restormer (Restormer.py:193-283): a 4-level U-Net of transformer blocks.

MDTA + GDFN blocks, pixel-(un)shuffle resamplers, encoder skips concatenated
with a 1x1 reduce at levels 3 and 2 and a plain concat at level 1,
refinement blocks, and a residual to the input. Attribute paths are the
reference torch model's (``encoder_level1.0.attn.qkv.weight``), so its
checkpoints load with a strict ``load_state_dict``.

Parameters stay fp32; ``dtype`` is the compute dtype every conv casts to, as
in the JAX model (image_restoration_tpu/models/restormer.py). With
``fused_block`` each TransformerBlock runs as the two-pass kernel pair of
``kernels/block.py`` on the (B, H, W, C) view of the channels-last
activations. Otherwise ``fused_attn`` runs its attention half as
``kernels/mdta.py`` and ``kernels/attn_core.py`` (three launches) and
``fused_gdfn`` its FFN half as ``kernels/gdfn.py`` (one launch): with both,
the three-kernel block. Each flag works without the other, and
``fused_block`` wins over both, as in the JAX model. A half without its flag
runs the plain modules.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from image_restoration_tpu_torch.kernels.attn_core import fused_mdta_core
from image_restoration_tpu_torch.kernels.block import (
    BlockParams, block_misfits, fused_block,
)
from image_restoration_tpu_torch.kernels.gdfn import fused_ln_gdfn
from image_restoration_tpu_torch.kernels.mdta import ln_qkv_dwconv
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.attention import MDTA
from image_restoration_tpu_torch.ops.common import Conv
from image_restoration_tpu_torch.ops.ffn import GDFN
from image_restoration_tpu_torch.ops.layernorm import LayerNorm
from image_restoration_tpu_torch.ops.resample import Downsample, Upsample


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()  # free when channels-last


class TransformerBlock(nn.Module):
    """LN -> MDTA -> +res; LN -> GDFN -> +res (Restormer.py:137-150)."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 use_bias: bool = False, ln_type: str = "WithBias",
                 fused_block: bool = False, fused_attn: bool = False,
                 fused_gdfn: bool = False, dtype=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.fused_block = fused_block
        self.fused_attn = fused_attn
        self.fused_gdfn = fused_gdfn
        self.norm1 = LayerNorm(dim, ln_type)
        self.attn = MDTA(dim, num_heads, use_bias, dtype=dtype)
        self.norm2 = LayerNorm(dim, ln_type)
        self.ffn = GDFN(dim, expansion, use_bias, dtype=dtype)

    def kernel_misfits(self) -> dict:
        """The kernel flags on that this block's width rules out."""
        return block_misfits(self.dim, self.num_heads, self.fused_block,
                             self.fused_attn, self.fused_gdfn)

    def block_params(self) -> BlockParams:
        n1, n2, at, ff = self.norm1.body, self.norm2.body, self.attn, self.ffn
        return BlockParams(
            n1.weight, getattr(n1, "bias", None),
            at.qkv.weight, at.qkv.bias, at.qkv_dwconv.weight,
            at.qkv_dwconv.bias, at.temperature, at.project_out.weight,
            at.project_out.bias,
            n2.weight, getattr(n2, "bias", None),
            ff.project_in.weight, ff.project_in.bias, ff.dwconv.weight,
            ff.dwconv.bias, ff.project_out.weight, ff.project_out.bias)

    def forward(self, x):
        if self.fused_block:
            out = fused_block(_nhwc(x), self.block_params(), self.num_heads,
                              1e-5)
            return out.permute(0, 3, 1, 2)
        if self.fused_attn:
            p, xh = self.block_params(), _nhwc(x)
            qkv = ln_qkv_dwconv(xh, p.front(), 1e-5)
            xh = fused_mdta_core(qkv, xh, p.temperature, p.proj_w, p.proj_b,
                                 self.num_heads)
            x = xh.permute(0, 3, 1, 2)
        else:
            x = x + self.attn(self.norm1(x))
        if self.fused_gdfn:
            out = fused_ln_gdfn(_nhwc(x), self.block_params().gdfn(), 1e-5)
            return out.permute(0, 3, 1, 2)
        return x + self.ffn(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    """Bias-free 3x3 conv embedding; the conv is ``proj`` as in the reference."""

    def __init__(self, in_c: int, embed_dim: int, dtype=None):
        super().__init__()
        self.proj = Conv(in_c, embed_dim, 3, padding=1, bias=False, dtype=dtype)

    def forward(self, x):
        return self.proj(x)


class BlockStackMixin:
    """Builds and runs the TransformerBlock stacks of a Restormer-block
    U-Net (Restormer, AdaIR): the counterpart of the JAX ``BlockStackMixin``
    (image_restoration_tpu/models/restormer.py), without ``scan_blocks``.
    Stacks are ``nn.Sequential``s, so their blocks keep the reference
    attribute paths (``encoder_level1.0.attn.qkv.weight``)."""

    def _init_blocks(self, expansion, use_bias, ln_type, fused_block,
                     fused_attn, fused_gdfn, dtype):
        self._block_kw = dict(expansion=expansion, use_bias=use_bias,
                              ln_type=ln_type, fused_block=fused_block,
                              fused_attn=fused_attn, fused_gdfn=fused_gdfn,
                              dtype=dtype)

    def _stack(self, dim: int, heads: int, n: int) -> nn.Sequential:
        return nn.Sequential(*[TransformerBlock(dim, heads, **self._block_kw)
                               for _ in range(n)])

    @staticmethod
    def _level(x, *stacks):
        # one layout change per level: the kernels read (B, H, W, C) views
        x = x.contiguous(memory_format=torch.channels_last)
        for s in stacks:
            x = s(x)
        return x


@register_model("restormer")
class Restormer(BlockStackMixin, nn.Module):
    """Takes and returns NCHW; the output is fp32."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, use_bias: bool = False,
                 ln_type: str = "WithBias", dual_pixel_task: bool = False,
                 fused_block: bool = False, fused_attn: bool = False,
                 fused_gdfn: bool = False, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.dual_pixel_task = dual_pixel_task
        self._init_blocks(ffn_expansion_factor, use_bias, ln_type,
                          fused_block, fused_attn, fused_gdfn, dtype)

        d, nb = dim, num_blocks
        self.patch_embed = OverlapPatchEmbed(inp_channels, d, dtype)
        self.encoder_level1 = self._stack(d, heads[0], nb[0])
        self.down1_2 = Downsample(d, dtype)
        self.encoder_level2 = self._stack(d * 2, heads[1], nb[1])
        self.down2_3 = Downsample(d * 2, dtype)
        self.encoder_level3 = self._stack(d * 4, heads[2], nb[2])
        self.down3_4 = Downsample(d * 4, dtype)
        self.latent = self._stack(d * 8, heads[3], nb[3])
        self.up4_3 = Upsample(d * 8, dtype)
        self.reduce_chan_level3 = Conv(d * 8, d * 4, 1, bias=use_bias,
                                       dtype=dtype)
        self.decoder_level3 = self._stack(d * 4, heads[2], nb[2])
        self.up3_2 = Upsample(d * 4, dtype)
        self.reduce_chan_level2 = Conv(d * 4, d * 2, 1, bias=use_bias,
                                       dtype=dtype)
        self.decoder_level2 = self._stack(d * 2, heads[1], nb[1])
        self.up2_1 = Upsample(d * 2, dtype)
        # level 1 stays at 2*dim after the concat: no reduce
        self.decoder_level1 = self._stack(d * 2, heads[0], nb[0])
        self.refinement = self._stack(d * 2, heads[0], num_refinement_blocks)
        if dual_pixel_task:
            self.skip_conv = Conv(d, d * 2, 1, bias=use_bias, dtype=dtype)
        self.output = Conv(d * 2, out_channels, 3, padding=1, bias=use_bias,
                           dtype=dtype)

    def forward(self, inp_img):
        x = inp_img if self.dtype is None else inp_img.to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = self.patch_embed(x)
        enc1 = self._level(feats, self.encoder_level1)
        enc2 = self._level(self.down1_2(enc1), self.encoder_level2)
        enc3 = self._level(self.down2_3(enc2), self.encoder_level3)
        latent = self._level(self.down3_4(enc3), self.latent)

        dec3 = torch.cat([self.up4_3(latent), enc3], dim=1)
        dec3 = self._level(self.reduce_chan_level3(dec3), self.decoder_level3)
        dec2 = torch.cat([self.up3_2(dec3), enc2], dim=1)
        dec2 = self._level(self.reduce_chan_level2(dec2), self.decoder_level2)
        dec1 = torch.cat([self.up2_1(dec2), enc1], dim=1)
        dec1 = self._level(dec1, self.decoder_level1, self.refinement)

        if self.dual_pixel_task:
            out = self.output(dec1 + self.skip_conv(feats))
        else:
            out = self.output(dec1) + x
        return out.float()
