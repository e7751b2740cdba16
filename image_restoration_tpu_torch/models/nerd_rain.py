"""NeRD-Rain's MultiscaleNet (CVPR'24, the large variant), the deraining
model of image_restoration_tpu/models/nerd_rain.py.

Three coarse-to-fine Restormer U-Nets at 1/4, 1/2 and full scale, each with
its own weights; the full-scale branch runs three chained U-Net passes with
context convs between them. An INR head (``ops/inr.py``) turns each coarser
branch's upsampled latent into an RGB residual that seeds the next scale,
and SKFF-style ``Fusion`` gates exchange latents between the passes. Every
stack is a run of Restormer TransformerBlocks (30 stacks, 78 blocks a
forward at blocks 2/3/3), so ``fused_block`` (K1 + K2 per block) and the
three-kernel block apply through ``BlockStackMixin`` unchanged.

Returns 7 fp32 images ordered full -> ... -> quarter scale, as the
reference's ``outputs[::-1]``; element 0 is the restored image. The
quarter-scale branch halves twice, so inputs must be multiples of 16
(``utils/options.py`` serves it with ``pad_multiple`` 16). The reference
defines ``reduce_chan_level1_max3`` and never uses it (its third decoder
pass reuses ``reduce_chan_level1_max2``); the port does not build it and
``nerd_rain_key_map`` drops its checkpoint keys.
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
from image_restoration_tpu_torch.ops.common import Conv
from image_restoration_tpu_torch.ops.inr import INR
from image_restoration_tpu_torch.ops.resample import Downsample, Upsample


def _interp(x, scale: float):
    """``F.interpolate(scale_factor=scale)``'s default nearest mode as the
    JAX ``_interp`` computes it on NCHW: output size int(n * scale), source
    index int(i / scale)."""
    h, w = x.shape[-2:]

    def idx(n):
        i = torch.arange(int(n * scale), device=x.device, dtype=torch.float32)
        return (i / scale).to(torch.int64)

    return x[:, :, idx(h)][:, :, :, idx(w)]


class Fusion(nn.Module):
    """SKFF-style gated fusion of two latents (model.py:203-232)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.query_conv = Conv(dim, dim, 3, padding=1, dtype=dtype)
        self.key_conv = Conv(dim, dim, 3, padding=1, dtype=dtype)
        self.gamma1 = Conv(2 * dim, 2, 3, padding=1, dtype=dtype)
        self.gamma2 = Conv(2 * dim, 2, 3, padding=1, dtype=dtype)

    def forward(self, x, y):
        attn = torch.sigmoid(self.query_conv(x) * self.key_conv(y))
        ax, ay = x * attn, y * attn
        gx = self.gamma1(torch.cat([x, ax], dim=1))
        gy = self.gamma2(torch.cat([y, ay], dim=1))
        return (x * gx[:, 0:1] + ax * gx[:, 1:2]
                + y * gy[:, 0:1] + ay * gy[:, 1:2])


def nerd_rain_key_map(key: str):
    """Drop ``reduce_chan_level1_max3``, which the reference defines and
    never uses (the JAX ``nerd_rain_key_map``)."""
    if key.startswith("reduce_chan_level1_max3"):
        return None
    return key


@register_model("nerd_rain", key_map=nerd_rain_key_map)
class MultiscaleNet(BlockStackMixin, nn.Module):
    """Takes NCHW (H and W multiples of 16) and returns a 7-tuple of fp32
    NCHW images, the full-scale restoration first."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (2, 3, 3),
                 heads: Sequence[int] = (1, 2, 4),
                 ffn_expansion_factor: float = 2.66, use_bias: bool = False,
                 ln_type: str = "WithBias", fused_block: bool = False,
                 fused_attn: bool = False, fused_gdfn: bool = False,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self._init_blocks(ffn_expansion_factor, use_bias, ln_type,
                          fused_block, fused_attn, fused_gdfn, dtype)
        d, nb, hd = dim, num_blocks, heads

        def conv(cin, cout, k=3):
            return Conv(cin, cout, k, padding=k // 2, bias=use_bias,
                        dtype=dtype)

        def level(i):  # (width, heads, blocks) of U-Net level i
            return self._stack(d * 2 ** i, hd[i], nb[i])

        def encoder(tag, down_tag):
            for i, name in enumerate(("encoder_level1", "encoder_level2",
                                      "latent")):
                setattr(self, f"{name}_{tag}", level(i))
            setattr(self, f"down1_2_{down_tag}", Downsample(d, dtype))
            setattr(self, f"down2_3_{down_tag}", Downsample(2 * d, dtype))

        def decoder(tag, red1=True):
            setattr(self, f"reduce_chan_level2_{tag}", conv(4 * d, 2 * d, 1))
            setattr(self, f"decoder_level2_{tag}", level(1))
            if red1:
                setattr(self, f"reduce_chan_level1_{tag}", conv(2 * d, d, 1))
            setattr(self, f"decoder_level1_{tag}", level(0))

        # quarter scale: encoder, INR to the half scale, decoder
        self.patch_embed_small = OverlapPatchEmbed(inp_channels, d, dtype)
        encoder("small", "small")
        self.upsmall2mid1 = Upsample(4 * d, dtype)
        self.upsmall2mid2 = Upsample(2 * d, dtype)
        self.INR = INR(d, dtype=dtype)
        self.up3_2_small = Upsample(4 * d, dtype)
        self.up2_1_small = Upsample(2 * d, dtype)
        decoder("small")
        self.output_small = conv(d, out_channels)
        # half scale: two passes
        self.patch_embed_mid = OverlapPatchEmbed(inp_channels, d, dtype)
        encoder("mid1", "mid")
        self.upmid2max1 = Upsample(4 * d, dtype)
        self.upmid2max2 = Upsample(2 * d, dtype)
        self.INR2 = INR(d, dtype=dtype)
        self.up3_2_mid = Upsample(4 * d, dtype)
        self.up2_1_mid = Upsample(2 * d, dtype)
        decoder("mid1")
        self.output_mid_context = conv(d, d)
        encoder("mid2", "mid2")
        self.BF3 = Fusion(4 * d, dtype)
        self.up3_2_mid2 = Upsample(4 * d, dtype)
        self.up2_1_mid2 = Upsample(2 * d, dtype)
        decoder("mid2")
        self.output_mid = conv(d, out_channels)
        # full scale: three passes; the third reuses reduce_chan_level1_max2
        self.patch_embed_max = OverlapPatchEmbed(inp_channels, d, dtype)
        for p, down in ((1, "max"), (2, "max2"), (3, "max3")):
            encoder(f"max{p}", down)
            setattr(self, "up3_2_" + down, Upsample(4 * d, dtype))
            setattr(self, "up2_1_" + down, Upsample(2 * d, dtype))
            decoder(f"max{p}", red1=p < 3)
        self.output_max_context1 = conv(d, d)
        self.output_max_context2 = conv(d, d)
        self.BF1 = Fusion(4 * d, dtype)
        self.BF2 = Fusion(4 * d, dtype)
        self.output_max = conv(d, out_channels)

    def _encode(self, x, tag, down_tag):
        """(level-1 features, level-2 features, latent) of one U-Net pass."""
        e1 = self._level(x, getattr(self, f"encoder_level1_{tag}"))
        e2 = self._level(getattr(self, f"down1_2_{down_tag}")(e1),
                         getattr(self, f"encoder_level2_{tag}"))
        lat = self._level(getattr(self, f"down2_3_{down_tag}")(e2),
                          getattr(self, f"latent_{tag}"))
        return e1, e2, lat

    def _decode(self, up, e2, e1, tag, up_tag, red1=None):
        """Decoder levels 2 and 1 from the upsampled latent ``up``."""
        g = lambda name: getattr(self, name)  # noqa: E731
        x = g(f"reduce_chan_level2_{tag}")(torch.cat([up, e2], dim=1))
        x = self._level(x, g(f"decoder_level2_{tag}"))
        x = g(f"up2_1_{up_tag}")(x)
        red1 = red1 or g(f"reduce_chan_level1_{tag}")
        x = red1(torch.cat([x, e1], dim=1))
        return self._level(x, g(f"decoder_level1_{tag}"))

    def forward(self, inp_img):
        x = inp_img if self.dtype is None else inp_img.to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        img_max, img_mid, img_small = x, _interp(x, 0.5), _interp(x, 0.25)
        outputs = [img_small]

        # quarter scale encoder -> INR -> half-scale input
        e1s, e2s, lat_s = self._encode(self.patch_embed_small(img_small),
                                       "small", "small")
        img_small_ = self.INR(self.upsmall2mid2(self.upsmall2mid1(lat_s)))
        img_small_ = img_small_ + img_small
        outputs.append(img_small_)
        mid_img = img_mid + _interp(img_small_, 2)

        # half scale, first encoder pass -> INR2 -> full-scale input
        e1m, e2m, lat_m = self._encode(self.patch_embed_mid(mid_img),
                                       "mid1", "mid")
        outputs.append(mid_img / 2)
        mid_img_ = self.INR2(self.upmid2max2(self.upmid2max1(lat_m))) + mid_img
        outputs.append(mid_img_)
        max_img = img_max + _interp(mid_img_, 2)

        # full scale: three chained U-Net passes
        e1x, e2x, lat_x = self._encode(self.patch_embed_max(max_img),
                                       "max1", "max")
        bff_max_1 = lat_x
        dx = self._decode(self.up3_2_max(lat_x), e2x, e1x, "max1", "max")
        dx = self.output_max_context1(dx)
        e1x, e2x, lat_x = self._encode(dx, "max2", "max2")
        bff_max_2 = lat_x
        dx = self._decode(self.up3_2_max2(lat_x), e2x, e1x, "max2", "max2")
        dx = self.output_max_context2(dx)
        e1x, e2x, lat_x = self._encode(dx, "max3", "max3")
        bff1 = _interp(self.BF1(bff_max_1, bff_max_2), 0.5)
        bff2 = _interp(self.BF2(bff_max_2, lat_x), 0.5)
        dx_dec2 = self.up3_2_max3(lat_x)

        # half scale, second pass, with the fused full-scale latents
        bff3_1 = lat_m
        dm = self._decode(self.up3_2_mid(lat_m + bff1), e2m, e1m, "mid1",
                          "mid")
        dm = self.output_mid_context(dm)
        e1m, e2m, lat_m = self._encode(dm, "mid2", "mid2")
        bff3 = _interp(self.BF3(bff3_1, lat_m), 0.5)
        dm_dec2 = self.up3_2_mid2(lat_m + bff2)

        # quarter-scale decoder with the fused latent
        ds = self._decode(self.up3_2_small(lat_s + bff3), e2s, e1s, "small",
                          "small")
        outputs.append(self.output_small(ds) + img_small)

        # half-scale decoder
        dm = self._decode(dm_dec2, e2m, e1m, "mid2", "mid2")
        dm = dm + _interp(ds, 2)
        outputs.append(self.output_mid(dm) + img_mid)

        # full-scale decoder, third pass
        dx = self._decode(dx_dec2, e2x, e1x, "max3", "max3",
                          red1=self.reduce_chan_level1_max2)
        dx = dx + _interp(dm, 2)
        outputs.append(self.output_max(dx) + img_max)
        return tuple(o.float() for o in outputs[::-1])
