"""DRSformer (DRSformer_arch.py:388-478): the CVPR'23 sparse deraining
transformer.

A Restormer-shaped 4-level U-Net whose blocks are TKSA (top-k sparse
channel attention) + MSFN (mixed-scale FFN), with an MEFC Subnet (a NAS-style
8-op bank mixed per sample, 4 residual steps) after the patch embedding and
as the refinement stage. Attribute paths are the reference torch model's
(``encoder_level1.0.ffn.dwconv5x5_1.weight``,
``encoder_level0.layers.1._ops.0._ops.3.op.4.weight``), so its checkpoints
load with a strict ``load_state_dict``; JAX trees load through
``utils.jax_bridge`` with :func:`drsformer_key_map`.

Parameters stay fp32; ``dtype`` is the compute dtype every conv casts to, as
in the JAX model (image_restoration_tpu/models/drsformer.py). With
``fused_block`` each TransformerBlock runs as ``kernels/drs_block.py``
``fused_drs_block`` and each Subnet's steps as ``kernels/mefc.py``
``fused_mefc_steps``, on the (B, H, W, C) view of the channels-last
activations; otherwise the plain modules run.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from image_restoration_tpu_torch.kernels.block import block_misfits
from image_restoration_tpu_torch.kernels.drs_block import (
    DRSBlockParams,
    fused_drs_block,
)
from image_restoration_tpu_torch.kernels.mefc import (
    DIL_KS,
    NUM_OPS,
    SEP_KS,
    StepParams,
    avg_pool3x3_exclude_pad,
    fused_mefc_steps,
    mefc_layout,
    mefc_takes,
)
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.attention import tksa_attention
from image_restoration_tpu_torch.ops.common import Conv, Linear
from image_restoration_tpu_torch.ops.layernorm import LayerNorm
from image_restoration_tpu_torch.ops.resample import Downsample, Upsample


def drsformer_key_map(key: str) -> str:
    """Reference torch key -> the key the JAX importer walks: the MEFC
    ``_ops`` and ``ca_fc`` list indices joined to their names
    (image_restoration_tpu/models/drsformer.py ``drsformer_key_map``)."""
    return key.replace("._ops.", "._ops_").replace(".ca_fc.", ".ca_fc_")


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()  # free when channels-last


class TKSA(nn.Module):
    """Top-k sparse channel attention (DRSformer_arch.py:101-173): MDTA's
    qkv front and projection, with four top-k masked softmaxes mixed by the
    learned scalars attn1..attn4."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False,
                 dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv(dim, dim * 3, 1, bias=bias, dtype=dtype)
        self.qkv_dwconv = Conv(dim * 3, dim * 3, 3, padding=1,
                               groups=dim * 3, bias=bias, dtype=dtype)
        self.project_out = Conv(dim, dim, 1, bias=bias, dtype=dtype)
        for i in range(4):
            setattr(self, f"attn{i + 1}", nn.Parameter(torch.tensor([0.2])))

    def mix(self):
        return torch.cat([self.attn1, self.attn2, self.attn3, self.attn4])

    def forward(self, x):
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        out = tksa_attention(q, k, v, self.temperature, self.mix(),
                             self.num_heads)
        return self.project_out(out)


class MSFN(nn.Module):
    """Mixed-scale FFN (DRSformer_arch.py:62-99): project_in to 2H, relu'd
    3x3 and 5x5 depthwise banks, per path a grouped conv (H groups of two
    channels) over the concat of the banks' halves, relu, project_out."""

    def __init__(self, dim: int, expansion: float = 2.66, bias: bool = False,
                 dtype=None):
        super().__init__()
        h = self.hidden = int(dim * expansion)
        self.project_in = Conv(dim, h * 2, 1, bias=bias, dtype=dtype)
        self.dwconv3x3 = Conv(h * 2, h * 2, 3, padding=1, groups=h * 2,
                              bias=bias, dtype=dtype)
        self.dwconv5x5 = Conv(h * 2, h * 2, 5, padding=2, groups=h * 2,
                              bias=bias, dtype=dtype)
        self.dwconv3x3_1 = Conv(h * 2, h, 3, padding=1, groups=h, bias=bias,
                                dtype=dtype)
        self.dwconv5x5_1 = Conv(h * 2, h, 5, padding=2, groups=h, bias=bias,
                                dtype=dtype)
        self.project_out = Conv(h * 2, dim, 1, bias=bias, dtype=dtype)

    def forward(self, x):
        x = self.project_in(x)
        x1_3, x2_3 = torch.relu(self.dwconv3x3(x)).chunk(2, dim=1)
        x1_5, x2_5 = torch.relu(self.dwconv5x5(x)).chunk(2, dim=1)
        x1 = torch.relu(self.dwconv3x3_1(torch.cat([x1_3, x1_5], dim=1)))
        x2 = torch.relu(self.dwconv5x5_1(torch.cat([x2_3, x2_5], dim=1)))
        return self.project_out(torch.cat([x1, x2], dim=1))


class TransformerBlock(nn.Module):
    """LN -> TKSA -> +res; LN -> MSFN -> +res (DRSformer_arch.py:175-186)."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 bias: bool = False, ln_type: str = "WithBias",
                 fused_block: bool = False, dtype=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.fused_block = fused_block
        self.norm1 = LayerNorm(dim, ln_type)
        self.attn = TKSA(dim, num_heads, bias, dtype=dtype)
        self.norm2 = LayerNorm(dim, ln_type)
        self.ffn = MSFN(dim, expansion, bias, dtype=dtype)

    def kernel_misfits(self) -> dict:
        """The kernel flags on that this block's width rules out, padded
        (K1's rule, ``kernels/block.py`` ``block_misfits``; K7 takes every
        width K1 does)."""
        return block_misfits(self.dim, self.num_heads, self.fused_block)

    def block_params(self) -> DRSBlockParams:
        n1, n2, at, ff = self.norm1.body, self.norm2.body, self.attn, self.ffn
        return DRSBlockParams(
            n1.weight, getattr(n1, "bias", None),
            at.qkv.weight, at.qkv.bias, at.qkv_dwconv.weight,
            at.qkv_dwconv.bias, at.temperature, at.mix(),
            at.project_out.weight, at.project_out.bias,
            n2.weight, getattr(n2, "bias", None),
            ff.project_in.weight, ff.project_in.bias,
            ff.dwconv3x3.weight, ff.dwconv3x3.bias,
            ff.dwconv5x5.weight, ff.dwconv5x5.bias,
            ff.dwconv3x3_1.weight, ff.dwconv3x3_1.bias,
            ff.dwconv5x5_1.weight, ff.dwconv5x5_1.bias,
            ff.project_out.weight, ff.project_out.bias)

    def forward(self, x):
        if self.fused_block:
            out = fused_drs_block(_nhwc(x), self.block_params(),
                                  self.num_heads, 1e-5)
            return out.permute(0, 3, 1, 2)
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


# --- MEFC (DRSformer_arch.py:189-353) ----------------------------------------

class SepConvOp(nn.Module):
    """dw_k -> 1x1 -> relu -> dw_k -> 1x1, bias-free; ``op.2`` is the relu."""

    def __init__(self, c: int, k: int, dtype=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype)
        self.op = nn.Sequential(
            Conv(c, c, k, padding=k // 2, groups=c, **kw), Conv(c, c, 1, **kw),
            nn.ReLU(), Conv(c, c, k, padding=k // 2, groups=c, **kw),
            Conv(c, c, 1, **kw))

    def forward(self, x):
        return self.op(x)


class DilConvOp(nn.Module):
    """Dilation-2 dw_k (padding k - 1) -> 1x1, bias-free."""

    def __init__(self, c: int, k: int, dtype=None):
        super().__init__()
        self.op = nn.Sequential(
            Conv(c, c, k, padding=k - 1, groups=c, bias=False, dtype=dtype,
                 dilation=2),
            Conv(c, c, 1, bias=False, dtype=dtype))

    def forward(self, x):
        return self.op(x)


class AvgPoolOp(nn.Module):
    def forward(self, x):
        return avg_pool3x3_exclude_pad(x)


class OperationLayer(nn.Module):
    """The 8-op bank (sep1, sep3, sep5, sep7, dil3, dil5, dil7, pool), each
    op scaled by its per-sample weight, concat -> 1x1 -> relu."""

    def __init__(self, c: int, dtype=None):
        super().__init__()
        self._ops = nn.ModuleList(
            [SepConvOp(c, k, dtype) for k in SEP_KS]
            + [DilConvOp(c, k, dtype) for k in DIL_KS] + [AvgPoolOp()])
        self._out = nn.Sequential(
            Conv(c * NUM_OPS, c, 1, bias=False, dtype=dtype), nn.ReLU())

    def step_params(self) -> StepParams:
        sep, dil = self._ops[:4], self._ops[4:7]
        return StepParams(
            [s.op[0].weight for s in sep], [s.op[1].weight for s in sep],
            [s.op[3].weight for s in sep], [s.op[4].weight for s in sep],
            [d.op[0].weight for d in dil], [d.op[1].weight for d in dil],
            self._out[0].weight)

    def forward(self, x, weights):
        states = [op(x) * weights[:, i].to(x.dtype).reshape(-1, 1, 1, 1)
                  for i, op in enumerate(self._ops)]
        return self._out(torch.cat(states, dim=1))


class OALayer(nn.Module):
    """GAP -> Linear -> relu -> Linear: per-sample logits (B, steps, 8)."""

    def __init__(self, c: int, steps: int, dtype=None):
        super().__init__()
        self.steps = steps
        self.dtype = dtype
        n = steps * NUM_OPS
        self.ca_fc = nn.Sequential(Linear(c, 2 * n, dtype=dtype), nn.ReLU(),
                                   Linear(2 * n, n, dtype=dtype))

    def forward(self, x):
        y = x.float().mean(dim=(2, 3)).to(self.dtype or x.dtype)
        return self.ca_fc(y).reshape(-1, self.steps, NUM_OPS)


class ReLUConv(nn.Module):
    """1x1 conv -> relu (the GroupOLs preprocess)."""

    def __init__(self, c: int, dtype=None):
        super().__init__()
        self.op = nn.Sequential(Conv(c, c, 1, bias=False, dtype=dtype),
                                nn.ReLU())

    def forward(self, x):
        return self.op(x)


class GroupOLs(nn.Module):
    """preprocess, then ``steps`` residual op-mixture steps."""

    def __init__(self, c: int, steps: int, fused: bool = False, dtype=None):
        super().__init__()
        self.c, self.fused = c, fused
        self.preprocess = ReLUConv(c, dtype)
        self._ops = nn.ModuleList([OperationLayer(c, dtype)
                                   for _ in range(steps)])

    def kernel_misfits(self) -> dict:
        """{"fused_block": why} when the steps are fused at a width K8 does
        not take even padded (``kernels/mefc.py`` ``mefc_layout``: above
        128 channels), else {}."""
        if not self.fused or mefc_takes(mefc_layout(self.c).cp):
            return {}
        return {"fused_block": f"an MEFC Subnet is {self.c} wide (K8 takes "
                               f"up to 128 channels)"}

    def forward(self, x, weights):
        s0 = self.preprocess(x)
        if self.fused:
            steps = [op.step_params() for op in self._ops]
            out = fused_mefc_steps(_nhwc(s0), steps, weights)
            return out.permute(0, 3, 1, 2)
        for st, op in enumerate(self._ops):
            s0 = torch.relu(op(s0, weights[:, st]) + s0)
        return s0


class Subnet(nn.Module):
    """MEFC: the OALayer's softmaxed mix weights drive the GroupOLs steps.
    ``layers`` = [OALayer, GroupOLs], as in the reference (layer_num 1)."""

    def __init__(self, dim: int, steps: int = 4, fused: bool = False,
                 dtype=None):
        super().__init__()
        self.layers = nn.ModuleList([OALayer(dim, steps, dtype),
                                     GroupOLs(dim, steps, fused, dtype)])

    def forward(self, x):
        logits = self.layers[0](x)
        weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        return self.layers[1](x, weights)


class OverlapPatchEmbed(nn.Module):
    """Bias-free 3x3 conv embedding; the conv is ``proj`` as in the reference."""

    def __init__(self, in_c: int, embed_dim: int, dtype=None):
        super().__init__()
        self.proj = Conv(in_c, embed_dim, 3, padding=1, bias=False, dtype=dtype)

    def forward(self, x):
        return self.proj(x)


@register_model("drsformer", key_map=drsformer_key_map)
class DRSformer(nn.Module):
    """Takes and returns NCHW; the output is fp32."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, use_bias: bool = False,
                 ln_type: str = "WithBias", fused_block: bool = False,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        bias = use_bias

        def stack(d, h, n):
            return nn.Sequential(*[
                TransformerBlock(d, h, ffn_expansion_factor, bias, ln_type,
                                 fused_block, dtype)
                for _ in range(n)])

        d, nb = dim, num_blocks
        self.patch_embed = OverlapPatchEmbed(inp_channels, d, dtype)
        self.encoder_level0 = Subnet(d, fused=fused_block, dtype=dtype)
        self.encoder_level1 = stack(d, heads[0], nb[0])
        self.down1_2 = Downsample(d, dtype)
        self.encoder_level2 = stack(d * 2, heads[1], nb[1])
        self.down2_3 = Downsample(d * 2, dtype)
        self.encoder_level3 = stack(d * 4, heads[2], nb[2])
        self.down3_4 = Downsample(d * 4, dtype)
        self.latent = stack(d * 8, heads[3], nb[3])
        self.up4_3 = Upsample(d * 8, dtype)
        self.reduce_chan_level3 = Conv(d * 8, d * 4, 1, bias=bias, dtype=dtype)
        self.decoder_level3 = stack(d * 4, heads[2], nb[2])
        self.up3_2 = Upsample(d * 4, dtype)
        self.reduce_chan_level2 = Conv(d * 4, d * 2, 1, bias=bias, dtype=dtype)
        self.decoder_level2 = stack(d * 2, heads[1], nb[1])
        self.up2_1 = Upsample(d * 2, dtype)
        # level 1 stays at 2*dim after the concat: no reduce
        self.decoder_level1 = stack(d * 2, heads[0], nb[0])
        self.refinement = Subnet(d * 2, fused=fused_block, dtype=dtype)
        self.output = Conv(d * 2, out_channels, 3, padding=1, bias=bias,
                           dtype=dtype)

    @staticmethod
    def _level(x, module):
        # one layout change per level: the kernels read (B, H, W, C) views
        return module(x.contiguous(memory_format=torch.channels_last))

    def forward(self, inp_img):
        x = inp_img if self.dtype is None else inp_img.to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = self._level(self.patch_embed(x), self.encoder_level0)
        enc1 = self._level(feats, self.encoder_level1)
        enc2 = self._level(self.down1_2(enc1), self.encoder_level2)
        enc3 = self._level(self.down2_3(enc2), self.encoder_level3)
        latent = self._level(self.down3_4(enc3), self.latent)

        dec3 = torch.cat([self.up4_3(latent), enc3], dim=1)
        dec3 = self._level(self.reduce_chan_level3(dec3), self.decoder_level3)
        dec2 = torch.cat([self.up3_2(dec3), enc2], dim=1)
        dec2 = self._level(self.reduce_chan_level2(dec2), self.decoder_level2)
        dec1 = torch.cat([self.up2_1(dec2), enc1], dim=1)
        dec1 = self._level(dec1, self.decoder_level1)
        dec1 = self._level(dec1, self.refinement)
        return (self.output(dec1) + x).float()
