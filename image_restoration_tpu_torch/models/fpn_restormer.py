"""FPN-Restormer: the FPN/PAFPN-fused Restormer with FFT-DSConv encoders
(experiment/.../20251120_Restormer_FFT_DSConv_Fusion_elementwise_gate_FPN_
frequency_aware_task_aware/src/net/model.py; image_restoration_tpu/models/
fpn_restormer.py), NCHW.

* Encoder levels of :class:`FrequencyAwareBlock` (:329-449; the fp32 fft2's
  magnitude and phase through a 1x1, a GAP-gated blend of a 3x3 average
  and its residual, a dilated depthwise-separable conv, BatchNorms, a
  cross-domain sigmoid attention and ECA; dilation 1/2/4/8 by level) or,
  with ``use_frequency_aware=False``, :class:`LightFFTDSConvBlock`
  (:264-323; the fft2's real and imaginary parts through a 1x1).
* :class:`FPNFusion` / :class:`PAFPNFusion` (:507-638) over (level 1,
  level 2, level 3, latent): lateral 1x1s to dims[1], channel-keeping
  pixel-shuffle up (and, for PAFPN, down) paths, PAFPN's task-aware SE
  weights, 3x3 outputs back to each level's width.
* A Restormer decoder of :class:`TransformerBlock`\\ s with
  :class:`GatedMDTA` (:126-212): ``gate_type`` None, ``headwise`` (one
  sigmoid gate a head) or ``elementwise`` (one a channel), taken from
  extra q channels.

The tanh GELU (:19-22) is used where the reference's own GELU class is;
the decoder's GDFN keeps the exact one. The BatchNorms follow the
forward's ``train`` argument, not the module's mode, as the JAX
``BatchNorm2d`` does: ``forward(x, train=True)`` normalises with the
batch's statistics and updates the running ones, as the JAX apply with
``mutable=["batch_stats"]``. The magnitude and phase of the fft2
coefficients come from ``ops/fft.py`` ``_polar``: JAX's values, and where a
coefficient is 0 the reference's gradient 0 (JAX's is NaN). No Pallas
kernel lies behind this model in JAX: with ``gate_type`` None a decoder
block is Restormer's TransformerBlock, which JAX runs as plain XLA, and so
does this port (plain torch). Parameters stay fp32 and ``dtype`` is the
compute dtype. Attribute paths are the reference's
(``encoder_level1.0.fft_mag_phase_extract.1.running_mean``,
``feature_fusion.scale_attn.0.1.weight``), which ``utils/jax_bridge.py``
maps onto the JAX tree without a key map.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.moce_ir import gap
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.attention import mdta_attention
from image_restoration_tpu_torch.ops.common import Conv, lecun_normal_
from image_restoration_tpu_torch.ops.fft import _polar
from image_restoration_tpu_torch.ops.ffn import GDFN
from image_restoration_tpu_torch.ops.layernorm import (
    BatchNorm2d, LayerNorm, batch_norm,
)
from image_restoration_tpu_torch.ops.resample import Downsample, Upsample


def gelu_tanh(x):
    """The tanh-approximate GELU (model.py:19-22)."""
    return F.gelu(x, approximate="tanh")


class ECAConv(nn.Conv1d):
    """ECA's bias-free 1-D conv over the channels, flax ``nn.Conv`` of one
    feature: lecun_normal weights, computing in ``dtype`` (the promotion
    of the input's and the weight's dtypes when None)."""

    def __init__(self, k_size: int, dtype=None):
        super().__init__(1, 1, k_size, padding=k_size // 2, bias=False)
        self.compute_dtype = dtype

    def reset_parameters(self):
        lecun_normal_(self.weight)

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        return F.conv1d(x.to(dt), self.weight.to(dt), None,
                        padding=self.padding)


class ECA(nn.Module):
    """Efficient channel attention (model.py:233-244): GAP, a 1-D conv of
    ``k_size`` over the channels, sigmoid, scale."""

    def __init__(self, k_size: int = 3, dtype=None):
        super().__init__()
        self.conv = ECAConv(k_size, dtype)

    def forward(self, x):
        y = self.conv(gap(x)[:, None, :])[:, 0]
        return x * torch.sigmoid(y)[:, :, None, None]


class DSConv(nn.Module):
    """A dilated depthwise ``kernel`` x ``kernel`` conv (padding =
    dilation), then a 1x1 (model.py:248-260)."""

    def __init__(self, channels: int, kernel: int = 3, dilation: int = 1,
                 bias: bool = False, dtype=None):
        super().__init__()
        self.depthwise = Conv(channels, channels, kernel, padding=dilation,
                              dilation=dilation, groups=channels, bias=bias,
                              dtype=dtype)
        self.pointwise = Conv(channels, channels, 1, bias=bias, dtype=dtype)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class GatedMDTA(nn.Module):
    """MDTA whose qkv conv carries the gate channels: q | gate | k | v
    (``headwise``: ``num_heads`` gate channels; ``elementwise``: ``dim``),
    the attention output times sigmoid(gate) before ``project_out``."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False,
                 gate_type: Optional[str] = None, dtype=None):
        super().__init__()
        self.dim, self.num_heads, self.gate_type = dim, num_heads, gate_type
        out_ch = {None: 3 * dim, "headwise": 3 * dim + num_heads,
                  "elementwise": 4 * dim}[gate_type]
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv(dim, out_ch, 1, bias=bias, dtype=dtype)
        self.qkv_dwconv = Conv(out_ch, out_ch, 3, padding=1, groups=out_ch,
                               bias=bias, dtype=dtype)
        self.project_out = Conv(dim, dim, 1, bias=bias, dtype=dtype)

    def forward(self, x):
        c, heads = self.dim, self.num_heads
        qkv = self.qkv_dwconv(self.qkv(x))
        g = {None: 0, "headwise": heads, "elementwise": c}[self.gate_type]
        q, gate, k, v = qkv.split([c, g, c, c], dim=1)
        out = mdta_attention(q, k, v, self.temperature, heads)
        if self.gate_type is not None:
            b, _, h, w = out.shape
            out = out.reshape(b, heads, -1, h, w)
            gate = gate.reshape(b, heads, -1, h, w)  # one channel a head,
            # or each head's own channels
            out = (out * torch.sigmoid(gate)).reshape(b, c, h, w)
        return self.project_out(out)


class TransformerBlock(nn.Module):
    """LN -> GatedMDTA -> +res; LN -> GDFN (exact GELU) -> +res
    (model.py:214-226)."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 bias: bool = False, ln_type: str = "WithBias",
                 gate_type: Optional[str] = None, dtype=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, ln_type)
        self.attn = GatedMDTA(dim, num_heads, bias, gate_type, dtype)
        self.norm2 = LayerNorm(dim, ln_type)
        self.ffn = GDFN(dim, expansion, bias, dtype=dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


def _spatial_branch(half, dilation, bias, dtype):
    """BN -> tanh GELU -> DSConv -> BN, the reference's Sequential (its
    GELU at index 1 holds nothing)."""
    return nn.ModuleList([BatchNorm2d(half), nn.Identity(),
                          DSConv(half, 3, dilation, bias, dtype),
                          BatchNorm2d(half)])


def _run_spatial(branch, x, train):
    s = gelu_tanh(batch_norm(branch[0], x, train))
    return batch_norm(branch[3], branch[2](s), train)


class FrequencyAwareBlock(nn.Module):
    """model.py:329-449: the channel halves through the spatial branch and
    the frequency branch (the fp32 fft2's |z| and angle, a 1x1, BN, tanh
    GELU; a GAP-gated blend of the 3x3 average (padding counted, as flax's
    ``avg_pool``) and the detail; DSConv, BN), a cross-domain sigmoid
    attention, ECA, plus the input."""

    def __init__(self, dim: int, bias: bool = False, dilation: int = 1,
                 dtype=None):
        super().__init__()
        half = dim // 2
        self.spatial_branch = _spatial_branch(half, dilation, bias, dtype)
        self.fft_mag_phase_extract = nn.ModuleList([
            Conv(dim, half, 1, bias=bias, dtype=dtype), BatchNorm2d(half)])
        self.freq_gate = nn.ModuleList([
            nn.Identity(), Conv(half, half, 1, bias=bias, dtype=dtype),
            nn.Identity(), Conv(half, half * 2, 1, bias=bias, dtype=dtype)])
        self.fft_conv = nn.ModuleList([DSConv(half, 3, dilation, bias, dtype),
                                       BatchNorm2d(half)])
        self.cross_domain_attn = nn.ModuleList([
            Conv(dim, dim // 4, 1, bias=bias, dtype=dtype), nn.Identity(),
            Conv(dim // 4, dim, 1, bias=bias, dtype=dtype)])
        self.eca = ECA(dtype=dtype)

    def forward(self, x, train: bool = False):
        spatial_x, freq_x = x.chunk(2, dim=1)
        s = _run_spatial(self.spatial_branch, spatial_x, train)

        z = torch.fft.fft2(freq_x.float())
        mag, pha = _polar(z.real, z.imag)
        mp = torch.cat([mag, pha], dim=1).to(x.dtype)
        ext = self.fft_mag_phase_extract
        f = gelu_tanh(batch_norm(ext[1], ext[0](mp), train))

        gate = self.freq_gate
        g = gate[3](gelu_tanh(gate[1](gap(f)[:, :, None, None])))
        low_w, high_w = torch.sigmoid(g).chunk(2, dim=1)
        smooth = F.avg_pool2d(f, 3, stride=1, padding=1,
                              count_include_pad=True)
        f = low_w * smooth + high_w * (f - smooth)
        f = batch_norm(self.fft_conv[1], self.fft_conv[0](f), train)

        fusion = torch.cat([s, f], dim=1)
        cda = self.cross_domain_attn
        ca = cda[2](gelu_tanh(cda[0](fusion)))
        return self.eca(fusion * torch.sigmoid(ca)) + x


class LightFFTDSConvBlock(nn.Module):
    """model.py:264-323: the spatial branch on one half; on the other the
    fp32 fft2's real and imaginary parts (concatenated) through a 1x1, BN,
    tanh GELU, DSConv, BN; ECA over both, plus the input."""

    def __init__(self, dim: int, bias: bool = False, dilation: int = 1,
                 dtype=None):
        super().__init__()
        half = dim // 2
        self.spatial_branch = _spatial_branch(half, dilation, bias, dtype)
        self.fft_branch = nn.ModuleList([
            Conv(dim, half, 1, bias=bias, dtype=dtype), BatchNorm2d(half),
            nn.Identity(), DSConv(half, 3, dilation, bias, dtype),
            BatchNorm2d(half)])
        self.eca = ECA(dtype=dtype)

    def forward(self, x, train: bool = False):
        spatial_x, fft_x = x.chunk(2, dim=1)
        s = _run_spatial(self.spatial_branch, spatial_x, train)
        z = torch.fft.fft2(fft_x.float())
        br = self.fft_branch
        f = br[0](torch.cat([z.real, z.imag], dim=1).to(x.dtype))
        f = br[3](gelu_tanh(batch_norm(br[1], f, train)))
        f = batch_norm(br[4], f, train)
        return self.eca(torch.cat([s, f], dim=1)) + x


class UpKeep(nn.Module):
    """UpsampleKeepChannels (model.py:494-503): a bias-free 3x3 to 4C, then
    PixelShuffle(2)."""

    def __init__(self, n_feat: int, dtype=None):
        super().__init__()
        self.body = nn.Sequential(
            Conv(n_feat, n_feat * 4, 3, padding=1, bias=False, dtype=dtype),
            nn.PixelShuffle(2))

    def forward(self, x):
        return self.body(x)


class DownKeep(nn.Module):
    """DownsampleKeepChannels (model.py:469-478): a bias-free 3x3 to C/4,
    then PixelUnshuffle(2)."""

    def __init__(self, n_feat: int, dtype=None):
        super().__init__()
        self.body = nn.Sequential(
            Conv(n_feat, n_feat // 4, 3, padding=1, bias=False, dtype=dtype),
            nn.PixelUnshuffle(2))

    def forward(self, x):
        return self.body(x)


class FPNFusion(nn.Module):
    """FPN_Fusion (model.py:507-548): lateral 1x1s to dims[1], the
    top-down path (UpKeep of the coarser sum plus the lateral), 3x3
    outputs to each level's width."""

    def __init__(self, dims: Sequence[int], bias: bool = False, dtype=None):
        super().__init__()
        d1 = dims[1]
        self.lateral_convs = nn.ModuleList(
            Conv(d, d1, 1, bias=bias, dtype=dtype) for d in dims)
        self.upsamples = nn.ModuleList(UpKeep(d1, dtype) for _ in range(3))
        self.output_convs = nn.ModuleList(
            Conv(d1, d, 3, padding=1, bias=bias, dtype=dtype) for d in dims)

    def _top_down(self, features):
        lat = [conv(f) for conv, f in zip(self.lateral_convs, features)]
        fused = [lat[3]]
        for up, tgt in zip(self.upsamples, (2, 1, 0)):
            fused.append(up(fused[-1]) + lat[tgt])
        return fused[::-1]  # [l1, l2, l3, latent]

    def forward(self, features):
        return [conv(f) for conv, f in zip(self.output_convs,
                                           self._top_down(features))]


class PAFPNFusion(FPNFusion):
    """PAFPN_Fusion (model.py:552-638): with ``task_aware`` each level
    first scaled by its SE weights (GAP, 1x1 to C/4, tanh GELU, 1x1,
    sigmoid); FPN's top-down path; then a bottom-up path (DownKeep of the
    finer sum plus the level) over levels 1-3, the latent kept."""

    def __init__(self, dims: Sequence[int], bias: bool = False,
                 task_aware: bool = True, dtype=None):
        super().__init__(dims, bias, dtype)
        self.task_aware = task_aware
        if task_aware:
            self.scale_attn = nn.ModuleList(nn.ModuleList([
                nn.Identity(), Conv(d, d // 4, 1, bias=bias, dtype=dtype),
                nn.Identity(), Conv(d // 4, d, 1, bias=bias, dtype=dtype)])
                for d in dims)
        self.downsamples = nn.ModuleList(DownKeep(dims[1], dtype)
                                         for _ in range(2))

    def forward(self, features):
        if self.task_aware:
            features = [
                f * torch.sigmoid(se[3](gelu_tanh(se[1](
                    gap(f)[:, :, None, None])))) for se, f in
                zip(self.scale_attn, features)]
        fused = self._top_down(features)
        enhanced = [fused[0]]
        for i, down in enumerate(self.downsamples):
            enhanced.append(down(enhanced[-1]) + fused[i + 1])
        enhanced.append(fused[3])
        return [conv(f) for conv, f in zip(self.output_convs, enhanced)]


@register_model("fpn_restormer")
class FPNRestormer(nn.Module):
    """Restormer_FFT_DSConv_Fusion (model.py:656-805): takes NCHW and
    returns the fp32 restoration (the input plus the network's output;
    with ``dual_pixel_task``, the output alone after a 1x1 skip of the
    patch embedding). ``forward(x, train=True)`` runs the BatchNorms on the
    batch's statistics and updates their running ones. The JAX training
    CLI cannot train this model (its step applies the parameters alone),
    and neither does the port's: it trains at model level."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, use_bias: bool = False,
                 ln_type: str = "WithBias", dual_pixel_task: bool = False,
                 fusion_type: str = "PAFPN", gate_type: Optional[str] = None,
                 use_frequency_aware: bool = True,
                 task_aware_fusion: bool = True, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.dual_pixel_task = dual_pixel_task
        dims = [dim * 2 ** i for i in range(4)]
        enc_cls = (FrequencyAwareBlock if use_frequency_aware
                   else LightFFTDSConvBlock)

        def encoder(level, n):
            return nn.ModuleList(enc_cls(dims[level], use_bias, 2 ** level,
                                         dtype) for _ in range(n))

        def decoder(d, h, n):
            return nn.ModuleList(
                TransformerBlock(d, h, ffn_expansion_factor, use_bias,
                                 ln_type, gate_type, dtype)
                for _ in range(n))

        self.patch_embed = Conv(inp_channels, dim, 3, padding=1, bias=False,
                                dtype=dtype)
        for i in range(3):
            setattr(self, f"encoder_level{i + 1}", encoder(i, num_blocks[i]))
            setattr(self, f"down{i + 1}_{i + 2}", Downsample(dims[i], dtype))
        self.latent = encoder(3, num_blocks[3])
        if fusion_type == "FPN":
            self.feature_fusion = FPNFusion(dims, use_bias, dtype)
        elif fusion_type == "PAFPN":
            self.feature_fusion = PAFPNFusion(dims, use_bias,
                                              task_aware_fusion, dtype)
        else:
            self.feature_fusion = None
        self.up4_3 = Upsample(dims[3], dtype)
        self.reduce_chan_level3 = Conv(dims[3], dims[2], 1, bias=use_bias,
                                       dtype=dtype)
        self.decoder_level3 = decoder(dims[2], heads[2], num_blocks[2])
        self.up3_2 = Upsample(dims[2], dtype)
        self.reduce_chan_level2 = Conv(dims[2], dims[1], 1, bias=use_bias,
                                       dtype=dtype)
        self.decoder_level2 = decoder(dims[1], heads[1], num_blocks[1])
        self.up2_1 = Upsample(dims[1], dtype)
        self.decoder_level1 = decoder(dims[1], heads[0], num_blocks[0])
        self.refinement = decoder(dims[1], heads[0], num_refinement_blocks)
        if dual_pixel_task:
            self.skip_conv = Conv(dim, dims[1], 1, bias=use_bias,
                                  dtype=dtype)
        self.output = Conv(dims[1], out_channels, 3, padding=1,
                           bias=use_bias, dtype=dtype)

    @staticmethod
    def _run(stack, x, *args):
        for blk in stack:
            x = blk(x, *args)
        return x

    def forward(self, inp_img, train: bool = False):
        x = inp_img if self.dtype is None else inp_img.to(self.dtype)
        inp1 = self.patch_embed(x)
        enc1 = self._run(self.encoder_level1, inp1, train)
        enc2 = self._run(self.encoder_level2, self.down1_2(enc1), train)
        enc3 = self._run(self.encoder_level3, self.down2_3(enc2), train)
        latent = self._run(self.latent, self.down3_4(enc3), train)
        feats = [enc1, enc2, enc3, latent]
        if self.feature_fusion is not None:
            feats = self.feature_fusion(feats)
        f1, f2, f3, fl = feats

        dec = self.reduce_chan_level3(torch.cat([self.up4_3(fl), f3], 1))
        dec = self._run(self.decoder_level3, dec)
        dec = self.reduce_chan_level2(torch.cat([self.up3_2(dec), f2], 1))
        dec = self._run(self.decoder_level2, dec)
        dec = self._run(self.decoder_level1,
                        torch.cat([self.up2_1(dec), f1], 1))
        dec = self._run(self.refinement, dec)
        if self.dual_pixel_task:
            return self.output(dec + self.skip_conv(inp1)).float()
        return (self.output(dec) + x).float()
