"""AdaIR (AdaIR-main/net/model.py): the all-in-one restoration model.

A Restormer U-Net (the blocks, resamplers and level helper of
``models/restormer.py``) with frequency mining and modulation on the
decoder: a FreModule after the latent level and after decoder levels 3 and
2 FFT-decomposes the input image, resized to the level, into high and low
bands with a learned per-sample rectangular low-pass mask, attends across
channels between each band and the decoder features, exchanges gates
between the bands (FreRefine), and merges ``out * para1 + y * para2``.

Port of image_restoration_tpu/models/adair.py. Attribute paths are the
reference torch model's, so the JAX package's ``import_state_dict`` and the
port's ``utils/jax_bridge.py`` map the two trees onto each other; the
reference's ``fre*.conv`` and ``fre*.score_gen``, which its forward never
uses, are not built (``adair_key_map`` drops them). ``para1`` and ``para2``
keep the JAX package's (1, 1, dim) shape.

The FreModules are plain torch: the JAX package has no kernel for them.
Their FFTs run in fp32 (``torch.fft``, ``norm="forward"``) with the shifts
as ``torch.roll`` by (h // 2, w // 2); the image is resized with the JAX
package's antialiased bilinear resize (``ops/resample.py``). The block
stacks take ``fused_block`` (serving: K1 + K2 per block) or ``fused_attn``
and ``fused_gdfn`` (the three-kernel block), as Restormer does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.models.restormer import (
    BlockStackMixin,
    OverlapPatchEmbed,
)
from image_restoration_tpu_torch.ops.attention import normalized_channel_logits
from image_restoration_tpu_torch.ops.common import Conv
from image_restoration_tpu_torch.ops.resample import (
    Downsample,
    Upsample,
    resize_bilinear,
)


class ChannelCrossAttention(nn.Module):
    """MDTA-style C x C cross attention: q from x, k and v from y, with a
    ``kv_kernel`` x ``kv_kernel`` depthwise conv on kv: 3 in AdaIR
    (model.py:177-232), 7 in the MoCE family's mixer
    (moce_ir_orignal.py:270-304)."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False,
                 dtype=None, kv_kernel: int = 3):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.q = Conv(dim, dim, 1, bias=bias, dtype=dtype)
        self.q_dwconv = Conv(dim, dim, 3, padding=1, groups=dim, bias=bias,
                             dtype=dtype)
        self.kv = Conv(dim, dim * 2, 1, bias=bias, dtype=dtype)
        self.kv_dwconv = Conv(dim * 2, dim * 2, kv_kernel,
                              padding=kv_kernel // 2, groups=dim * 2,
                              bias=bias, dtype=dtype)
        self.project_out = Conv(dim, dim, 1, bias=bias, dtype=dtype)

    def forward(self, x, y):
        b, c, h, w = x.shape
        heads = self.num_heads
        q = self.q_dwconv(self.q(x))
        k, v = self.kv_dwconv(self.kv(y)).chunk(2, dim=1)

        def tokens(t):  # (B, H*W, heads, ch), channels head-major
            return t.permute(0, 2, 3, 1).reshape(b, h * w, heads, c // heads)

        attn = normalized_channel_logits(tokens(q), tokens(k))
        attn = attn * self.temperature.reshape(1, heads, 1, 1).float()
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bhcd,bnhd->bnhc", attn.float(),
                           tokens(v).float()).to(x.dtype)
        return self.project_out(out.reshape(b, h, w, c).permute(0, 3, 1, 2))


class SpatialGate(nn.Module):
    """Channel max and mean -> 7x7 conv -> sigmoid (model.py:234-247)."""

    def __init__(self, dtype=None):
        super().__init__()
        self.spatial = Conv(2, 1, 7, padding=3, bias=False, dtype=dtype)

    def forward(self, x):
        s = torch.cat([x.amax(dim=1, keepdim=True),
                       x.mean(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.spatial(s))


class ChannelGate(nn.Module):
    """Average- and max-pooled shared MLP -> sigmoid (model.py:251-269)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.mlp = nn.Sequential(
            Conv(dim, dim // 16, 1, bias=False, dtype=dtype), nn.ReLU(),
            Conv(dim // 16, dim, 1, bias=False, dtype=dtype))

    def forward(self, x):
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        return torch.sigmoid(self.mlp(avg) + self.mlp(mx))


class FreRefine(nn.Module):
    """Exchange gates between the bands, sum, project (model.py:274-291)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.SpatialGate = SpatialGate(dtype)
        self.ChannelGate = ChannelGate(dim, dtype)
        self.proj = Conv(dim, dim, 1, bias=True, dtype=dtype)

    def forward(self, low, high):
        sw = self.SpatialGate(high)
        cw = self.ChannelGate(low)
        return self.proj(low * sw + high * cw)


def adaptive_rect_mask(h: int, w: int, h_frac, w_frac, n: int = 128):
    """Per-sample centred low-pass rectangle, (B, 1, h, w) fp32.

    h_frac, w_frac: (B,) in [0, 1]. The half-extents are
    floor((h // n) * frac), in frac's dtype: the reference's int()
    truncation (model.py:351-353). Below n pixels the rectangle is empty.
    """
    hh = torch.floor((h // n) * h_frac).to(torch.int64).reshape(-1, 1, 1, 1)
    wh = torch.floor((w // n) * w_frac).to(torch.int64).reshape(-1, 1, 1, 1)
    rows = torch.arange(h, device=hh.device).reshape(1, 1, h, 1)
    cols = torch.arange(w, device=wh.device).reshape(1, 1, 1, w)
    row_in = (rows >= h // 2 - hh) & (rows < h // 2 + hh)
    col_in = (cols >= w // 2 - wh) & (cols < w // 2 + wh)
    return (row_in & col_in).float()


def frequency_bands(x, h_frac, w_frac, n: int, dtype):
    """(high, low) bands of NCHW ``x``: |ifft2| of its centred spectrum
    outside and inside the per-sample rectangle of
    :func:`adaptive_rect_mask`, FFTs in fp32 with ``norm="forward"`` and the
    shifts as rolls by (h // 2, w // 2), cast to ``dtype``."""
    h, w = x.shape[-2:]
    mask = adaptive_rect_mask(h, w, h_frac, w_frac, n)
    fft = torch.fft.fft2(x.float(), norm="forward")
    fft = torch.roll(fft, (h // 2, w // 2), dims=(-2, -1))  # fftshift

    def band(masked):
        z = torch.roll(masked, (-(h // 2), -(w // 2)), dims=(-2, -1))
        return torch.fft.ifft2(z, norm="forward").abs().to(dtype)

    return band(fft * (1.0 - mask)), band(fft * mask)


class FreModule(nn.Module):
    """Adaptive frequency learning block (model.py:295-372) on a 3-channel
    image."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False,
                 mask_n: int = 128, dtype=None):
        super().__init__()
        self.mask_n = mask_n
        self.para1 = nn.Parameter(torch.zeros(1, 1, dim))
        self.para2 = nn.Parameter(torch.ones(1, 1, dim))
        self.conv1 = Conv(3, dim, 3, padding=1, bias=False, dtype=dtype)
        self.rate_conv = nn.Sequential(
            Conv(dim, dim // 8, 1, bias=False, dtype=dtype), nn.GELU(),
            Conv(dim // 8, 2, 1, bias=False, dtype=dtype))

        def cross():
            return ChannelCrossAttention(dim, num_heads, bias, dtype=dtype)

        self.channel_cross_l = cross()
        self.channel_cross_h = cross()
        self.channel_cross_agg = cross()
        self.frequency_refine = FreRefine(dim, dtype)

    def forward(self, img, y):
        b, _, h, w = y.shape
        dt = y.dtype
        x = self.conv1(resize_bilinear(img.float(), h, w).to(dt))

        # learned per-sample low-pass extents
        thr = self.rate_conv(x.mean(dim=(2, 3), keepdim=True))
        thr = torch.sigmoid(thr.reshape(b, 2))
        high, low = frequency_bands(x, thr[:, 0], thr[:, 1], self.mask_n, dt)
        high = self.channel_cross_l(high, y)
        low = self.channel_cross_h(low, y)
        agg = self.frequency_refine(low, high)
        out = self.channel_cross_agg(y, agg)
        return (out * self.para1.reshape(1, -1, 1, 1).to(out.dtype)
                + y * self.para2.reshape(1, -1, 1, 1).to(dt))


def adair_key_map(key: str):
    """Drop the FreModule parameters that the reference defines but never
    uses in its forward (model.py:299-304: ``.conv`` and ``.score_gen``);
    the JAX package's ``adair_key_map``."""
    parts = key.split(".")
    if len(parts) >= 2 and parts[0].startswith("fre") and parts[1] in (
            "conv", "score_gen"):
        return None
    return key


@register_model("adair", key_map=adair_key_map)
class AdaIR(BlockStackMixin, nn.Module):
    """Takes and returns NCHW; the output is fp32. The FreModules run at
    ``heads[2]`` heads at every level, as in the reference."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, use_bias: bool = False,
                 ln_type: str = "WithBias", fused_block: bool = False,
                 fused_attn: bool = False, fused_gdfn: bool = False,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
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
        self.fre1 = FreModule(d * 8, heads[2], use_bias, dtype=dtype)
        self.fre2 = FreModule(d * 4, heads[2], use_bias, dtype=dtype)
        self.fre3 = FreModule(d * 2, heads[2], use_bias, dtype=dtype)
        self.up4_3 = Upsample(d * 8, dtype)
        self.reduce_chan_level3 = Conv(d * 8, d * 4, 1, bias=use_bias,
                                       dtype=dtype)
        self.decoder_level3 = self._stack(d * 4, heads[2], nb[2])
        self.up3_2 = Upsample(d * 4, dtype)
        self.reduce_chan_level2 = Conv(d * 4, d * 2, 1, bias=use_bias,
                                       dtype=dtype)
        self.decoder_level2 = self._stack(d * 2, heads[1], nb[1])
        self.up2_1 = Upsample(d * 2, dtype)
        self.decoder_level1 = self._stack(d * 2, heads[0], nb[0])
        self.refinement = self._stack(d * 2, heads[0], num_refinement_blocks)
        self.output = Conv(d * 2, out_channels, 3, padding=1, bias=use_bias,
                           dtype=dtype)

    def forward(self, inp_img):
        x = inp_img if self.dtype is None else inp_img.to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        enc1 = self._level(self.patch_embed(x), self.encoder_level1)
        enc2 = self._level(self.down1_2(enc1), self.encoder_level2)
        enc3 = self._level(self.down2_3(enc2), self.encoder_level3)
        latent = self.fre1(x, self._level(self.down3_4(enc3), self.latent))

        dec3 = torch.cat([self.up4_3(latent), enc3], dim=1)
        dec3 = self._level(self.reduce_chan_level3(dec3), self.decoder_level3)
        dec3 = self.fre2(x, dec3)
        dec2 = torch.cat([self.up3_2(dec3), enc2], dim=1)
        dec2 = self._level(self.reduce_chan_level2(dec2), self.decoder_level2)
        dec2 = self.fre3(x, dec2)
        dec1 = torch.cat([self.up2_1(dec2), enc1], dim=1)
        dec1 = self._level(dec1, self.decoder_level1, self.refinement)
        return (self.output(dec1) + x).float()
