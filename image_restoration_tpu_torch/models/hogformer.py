"""HOGformer (HOGformer-main/settingI/basicsr/models/archs/hogformer_arch.py;
image_restoration_tpu/models/hogformer.py), NCHW.

* ``Attention_DHOGSA`` (:164-309): dual HOG-sorted attention. The first
  half of the channels is re-ordered within 8x8 patches by HOG-weighted
  gradient magnitude and enriched with a projected, upsampled HOG
  histogram map; a 5-way qkv then feeds two channel attentions over the
  tokens sorted globally by orientation-weighted gradient magnitude, one
  grouping tokens in contiguous chunks a head ("box"), one strided, whose
  outputs are multiplied and un-sorted.
* ``FFN_DIFF`` (:106-143): a pixel-shuffle FFN, mish-gated 5x5 and dilated
  3x3 depthwise branches at twice the resolution with a feature-decompose
  residual.
* Parameter-free LayerNorms (:28-57), a U-Net (:367-489) with AvgPool
  ``SkipPatchEmbed`` image pyramids fed into each encoder level.

The port runs the reference's order of operations: the JAX package's
polyphase ``FFN_DIFF`` (the shuffle folded into ``project_in``) and its
one-hot permutation matmuls are TPU layouts of the same function. Sorts
are ``torch.sort(stable=True)``: the JAX ``argsort`` is stable, so tied
keys (zero padding, flat regions) keep their index order in both. With
one head both groupings are the whole token set, and channel attention is
invariant under a permutation of the tokens, so the global sort is
skipped, as in JAX. Plain torch throughout (plain XLA in JAX). Attribute
paths follow the JAX tree (``encoder_level1.0.attn_g_spatial.qkv``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.attention import (
    normalized_channel_logits_tok_minor,
)
from image_restoration_tpu_torch.ops.common import Conv, gelu_exact
from image_restoration_tpu_torch.ops.resample import Downsample, Upsample


def _ln_plain(x, ln_type: str, eps: float = 1e-5):
    """Parameter-free LayerNorm over the channels of NCHW in fp32, cast
    back (hogformer_arch.py:28-57: the affine is disabled)."""
    xf = x.float()
    var = xf.var(dim=1, keepdim=True, unbiased=False)
    if ln_type != "BiasFree":
        xf = xf - xf.mean(dim=1, keepdim=True)
    return (xf / torch.sqrt(var + eps)).to(x.dtype)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def _inverse_permutation(idx):
    """inv with inv[..., idx[..., i]] = i, one scatter pass."""
    ar = torch.arange(idx.shape[-1], device=idx.device).expand_as(idx)
    return torch.empty_like(idx).scatter_(-1, idx, ar)


def _argsort(key):
    """Ascending, ties in index order (the JAX ``argsort``)."""
    return torch.sort(key, dim=-1, stable=True).indices


def _ori_bin(gx, gy, n_bins: int):
    """Each gradient's orientation bin, floor((atan2(gy, gx) + pi) / 2pi *
    n_bins) mod n_bins, in gx's dtype."""
    ori = torch.atan2(gy, gx)
    return (((ori + math.pi) / (2 * math.pi) * n_bins).to(torch.int32)
            % n_bins).to(gx.dtype)


@contextlib.contextmanager
def decision_tape(tape: list, replay: bool = False):
    """Records the model's discrete decisions, each sort permutation and
    orientation-bin map in call order, into ``tape`` (on the host), or,
    with ``replay``, has the model take them from it. A key within fp32
    rounding of a tie or a bin edge decides differently in two summation
    orders (two devices, or JAX's jitted and op-by-op forwards), so one
    device's forward is held to another's under the other's decisions
    (``chip_smoke.py`` phase 3l, ``tests/test_torch_family_cuda.py``)."""
    argsort, ori_bin = _argsort, _ori_bin

    def taped(fn):
        def run(x, *rest):
            if replay:
                return tape.pop(0).to(x.device)
            out = fn(x, *rest)
            tape.append(out.cpu())
            return out
        return run

    globals().update(_argsort=taped(argsort), _ori_bin=taped(ori_bin))
    try:
        yield tape
    finally:
        globals().update(_argsort=argsort, _ori_bin=ori_bin)


_SOBEL = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _sobel(x):
    """(gx, gy): depthwise Sobel filters over NCHW, zero padding 1."""
    c = x.shape[1]
    kx = torch.tensor(_SOBEL, dtype=x.dtype, device=x.device)
    kern = torch.stack([kx, kx.t()])[:, None].repeat(c, 1, 1, 1)
    g = F.conv2d(x, kern, padding=1, groups=c).unflatten(1, (c, 2))
    return g[:, :, 0], g[:, :, 1]


def _split_patches(x, p: int):
    """NCHW -> (B, nP, C, p*p) patch tokens, zero-padded to multiples of
    p at the bottom and right (hogformer_arch.py:223-231)."""
    b, c, h, w = x.shape
    x = F.pad(x, (0, (-w) % p, 0, (-h) % p))
    nh, nw = x.shape[2] // p, x.shape[3] // p
    x = x.reshape(b, c, nh, p, nw, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, nh * nw, c, p * p), (h, w, nh, nw)


def _merge_patches(x, p: int, info):
    h, w, nh, nw = info
    b, _, c, _ = x.shape
    x = x.reshape(b, nh, nw, c, p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, nh * p, nw * p)[:, :, :h, :w]


def _permute_patches(x, idx, p: int):
    """Each p x p patch of NCHW ``x`` with its pixels taken in the order
    ``idx`` (B, nP, p*p) gives: pixel s of a patch becomes its pixel
    idx[s]."""
    t, info = _split_patches(x, p)
    t = torch.gather(t, 3, idx[:, :, None].expand(-1, -1, t.shape[2], -1))
    return _merge_patches(t, p, info)


class ElementScale(nn.Module):
    """A learnable per-channel scale (hogformer_arch.py:92-103)."""

    def __init__(self, dim: int, init_value: float = 0.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x):
        return x * self.scale.reshape(1, -1, 1, 1).to(x.dtype)


class FFN_DIFF(nn.Module):
    """hogformer_arch.py:106-143: 1x1 to 2 hidden, PixelShuffle(2), a 5x5
    depthwise branch and a dilation-2 3x3 depthwise branch over the two
    halves (q = hidden/4 channels each), mish(second) * first, the
    feature decomposition y + sigma * (y - GELU(1x1 to one channel)),
    PixelUnshuffle(2), 1x1 back."""

    def __init__(self, dim: int, expansion: float = 2.667,
                 use_bias: bool = False, dtype=None):
        super().__init__()
        hidden = int(dim * expansion)
        q = hidden // 4
        kw = dict(bias=use_bias, dtype=dtype)
        self.project_in = Conv(dim, hidden * 2, 1, **kw)
        self.dwconv_5 = Conv(q, q, 5, padding=2, groups=q, **kw)
        self.dwconv_dilated2_1 = Conv(q, q, 3, padding=2, dilation=2,
                                      groups=q, **kw)
        self.decompose = Conv(q, 1, 1, dtype=dtype)
        self.sigma = ElementScale(q, 1e-5)
        self.project_out = Conv(4 * q, dim, 1, **kw)

    def forward(self, x):
        x1, x2 = F.pixel_shuffle(self.project_in(x), 2).chunk(2, dim=1)
        y = mish(self.dwconv_dilated2_1(x2)) * self.dwconv_5(x1)
        g = gelu_exact(self.decompose(y).float()).to(y.dtype)
        y = y + self.sigma(y - g)
        return self.project_out(F.pixel_unshuffle(y, 2))


def _channel_attn(q, k, v, temperature):
    """Channel attention over (B, heads, d, T) q, k, v: fp32 logits of the
    L2-normalised rows times the temperature, softmax_1 (exp / (sum(exp) +
    1), :192-195), the weights rounded to v's dtype times v."""
    attn = torch.exp(normalized_channel_logits_tok_minor(q, k)
                     * temperature.float())
    attn = attn / (attn.sum(-1, keepdim=True) + 1.0)
    return torch.matmul(attn.to(v.dtype), v)


class Attention_DHOGSA(nn.Module):
    """hogformer_arch.py:164-309."""

    def __init__(self, dim: int, num_heads: int, use_bias: bool = False,
                 patch_size: int = 8, n_bins: int = 9, dtype=None):
        super().__init__()
        self.num_heads, self.patch_size, self.n_bins = (num_heads,
                                                        patch_size, n_bins)
        kw = dict(bias=use_bias, dtype=dtype)
        self.bin_proj = Conv(n_bins, dim // 2, 1, **kw)
        self.qkv = Conv(dim, dim * 5, 1, **kw)
        self.qkv_dwconv = Conv(dim * 5, dim * 5, 3, padding=1,
                               groups=dim * 5, **kw)
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.project_out = Conv(dim, dim, 1, **kw)

    def _reshape_attn(self, q, k, v, box: bool):
        """Channel attention over factor-grouped tokens (:202-221) of
        (B, C, T) q, k, v, T zero-padded to a multiple of the heads. Box
        groups token f * hw + j as (f, j), strided token j * f + f as (f,
        j); the attention matrix is (C / heads * heads)^2 a head."""
        b, c, t = q.shape
        f = self.num_heads
        tt = t + (-t) % f
        hw, cph = tt // f, c // f

        def arrange(x):
            x = F.pad(x, (0, tt - t))
            if box:
                return x.reshape(b, f, cph * f, hw)
            x = x.reshape(b, f, cph, hw, f).transpose(3, 4)
            return x.reshape(b, f, cph * f, hw)

        out = _channel_attn(arrange(q), arrange(k), arrange(v),
                            self.temperature)
        if not box:
            out = out.reshape(b, f, cph, f, hw).transpose(3, 4)
        return out.reshape(b, c, tt)[:, :, :t]

    def forward(self, x):
        b, c, h, w = x.shape
        half, p = c // 2, self.patch_size

        # HOG re-ordering of the first channel half within patches (:241-264)
        x_half = x[:, :half]
        gx, gy = _sobel(x_half)
        mag = torch.sqrt(gx * gx + gy * gy + 1e-6)
        p_mag, (_, _, nh, nw) = _split_patches(mag, p)
        p_bin = _split_patches(_ori_bin(gx, gy, self.n_bins), p)[0].long()
        # each pixel lies in one bin: the reference's per-bin loop
        # (:254-257) is mag * (bin + 1) and a one-hot histogram
        sort_values = (p_mag * (p_bin + 1).to(p_mag.dtype)).sum(2)
        onehot = F.one_hot(p_bin, self.n_bins).to(p_mag.dtype)
        hog = (p_mag[..., None] * onehot).mean(dim=(2, 3))  # (b, nP, bins)
        hog = hog / (hog.sum(-1, keepdim=True) + 1e-8)
        idx_patch = _argsort(sort_values)  # (b, nP, p*p)
        hog_map = self.bin_proj(hog.transpose(1, 2).reshape(
            b, self.n_bins, nh, nw))
        # an upsampling (nh <= h): no antialias filter, as in JAX
        hog_map = F.interpolate(hog_map, size=(h, w), mode="bilinear",
                                align_corners=False)
        x = torch.cat([_permute_patches(x_half, idx_patch, p) + hog_map,
                       x[:, half:]], dim=1)

        # 5-way qkv, attention over the globally sorted tokens (:279-301)
        qkv = self.qkv_dwconv(self.qkv(x))
        if self.num_heads == 1:
            q1, k1, q2, k2, vs = qkv.flatten(2)[:, None].chunk(5, dim=2)
            out = (_channel_attn(q1, k1, vs, self.temperature)
                   * _channel_attn(q2, k2, vs, self.temperature))
        else:
            gxv, gyv = _sobel(qkv[:, 4 * c:])
            magv = torch.sqrt(gxv * gxv + gyv * gyv + 1e-6)
            oriv = (torch.atan2(gyv, gxv) + math.pi) / (2 * math.pi)
            idx = _argsort((magv * oriv).sum(1).flatten(1))  # (b, T)
            qkv_s = torch.gather(qkv.flatten(2), 2,
                                 idx[:, None].expand(-1, 5 * c, -1))
            q1, k1, q2, k2, vs = qkv_s.chunk(5, dim=1)
            # the product commutes with the shared permutation: multiply
            # while sorted, un-sort once
            out = (self._reshape_attn(q1, k1, vs, True)
                   * self._reshape_attn(q2, k2, vs, False))
            inv = _inverse_permutation(idx)
            out = torch.gather(out, 2, inv[:, None].expand(-1, c, -1))
        out = self.project_out(out.reshape(b, c, h, w))

        # un-sort the first half within patches (:304-308)
        out_half = _permute_patches(out[:, :half],
                                    _inverse_permutation(idx_patch), p)
        return torch.cat([out_half, out[:, half:]], dim=1)


class TransformerBlock(nn.Module):
    """hogformer_arch.py:148-160: x + attention(LN(x)); x + FFN(LN(x))."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.667,
                 use_bias: bool = False, ln_type: str = "WithBias",
                 dtype=None):
        super().__init__()
        self.ln_type = ln_type
        self.attn_g_spatial = Attention_DHOGSA(dim, num_heads, use_bias,
                                               dtype=dtype)
        self.ffn = FFN_DIFF(dim, expansion, use_bias, dtype)

    def forward(self, x):
        x = x + self.attn_g_spatial(_ln_plain(x, self.ln_type))
        return x + self.ffn(_ln_plain(x, self.ln_type))


class SkipPatchEmbed(nn.Module):
    """AvgPool 2 -> 1x1 -> depthwise 3x3, no biases (hogformer_arch.py
    :326-339)."""

    def __init__(self, dim: int = 3, use_bias: bool = False, dtype=None):
        super().__init__()
        kw = dict(bias=use_bias, dtype=dtype)
        self.proj = nn.Sequential(
            nn.AvgPool2d(2, 2), Conv(dim, dim, 1, **kw),
            Conv(dim, dim, 3, padding=1, groups=dim, **kw))

    def forward(self, x):
        return self.proj(x)


@register_model("hogformer")
class HOGformer(nn.Module):
    """hogformer_arch.py:367-489. Takes NCHW (sides multiples of 8) and
    returns the fp32 restoration, the input plus the network's output."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.667,
                 use_bias: bool = False, ln_type: str = "WithBias",
                 dual_pixel_task: bool = False, dtype=None):
        super().__init__()
        d = dim
        self.dtype = dtype

        def blocks(c, h, n):
            return nn.ModuleList(
                TransformerBlock(c, h, ffn_expansion_factor, use_bias,
                                 ln_type, dtype) for _ in range(n))

        def conv1(cin, cout):
            return Conv(cin, cout, 1, bias=use_bias, dtype=dtype)

        self.patch_embed = Conv(inp_channels, d, 3, padding=1, bias=False,
                                dtype=dtype)
        self.encoder_level1 = blocks(d, heads[0], num_blocks[0])
        self.down1_2 = Downsample(d, dtype)
        self.skip_patch_embed1 = SkipPatchEmbed(3, False, dtype)
        self.reduce_chan_level_1 = conv1(d * 2 + 3, d * 2)
        self.encoder_level2 = blocks(d * 2, heads[1], num_blocks[1])
        self.down2_3 = Downsample(d * 2, dtype)
        self.skip_patch_embed2 = SkipPatchEmbed(3, False, dtype)
        self.reduce_chan_level_2 = conv1(d * 4 + 3, d * 4)
        self.encoder_level3 = blocks(d * 4, heads[2], num_blocks[2])
        self.down3_4 = Downsample(d * 4, dtype)
        self.skip_patch_embed3 = SkipPatchEmbed(3, False, dtype)
        self.reduce_chan_level_3 = conv1(d * 8 + 3, d * 8)
        self.latent = blocks(d * 8, heads[3], num_blocks[3])
        self.up4_3 = Upsample(d * 8, dtype)
        self.reduce_chan_level3 = conv1(d * 8, d * 4)
        self.decoder_level3 = blocks(d * 4, heads[2], num_blocks[2])
        self.up3_2 = Upsample(d * 4, dtype)
        self.reduce_chan_level2 = conv1(d * 4, d * 2)
        self.decoder_level2 = blocks(d * 2, heads[1], num_blocks[1])
        self.up2_1 = Upsample(d * 2, dtype)
        self.decoder_level1 = blocks(d * 2, heads[0], num_blocks[0])
        self.refinement = blocks(d * 2, heads[0], num_refinement_blocks)
        # the reference creates skip_conv, and its forward never uses it
        self.skip_conv = conv1(d, d * 2) if dual_pixel_task else None
        self.output = Conv(d * 2, out_channels, 3, padding=1, bias=use_bias,
                           dtype=dtype)

    def forward(self, inp_img):
        x = inp_img if self.dtype is None else inp_img.to(self.dtype)

        def run(blocks, t):
            for blk in blocks:
                t = blk(t)
            return t

        enc1 = run(self.encoder_level1, self.patch_embed(x))
        skip1 = self.skip_patch_embed1(x)
        enc2 = run(self.encoder_level2, self.reduce_chan_level_1(
            torch.cat([self.down1_2(enc1), skip1], dim=1)))
        skip2 = self.skip_patch_embed2(skip1)
        enc3 = run(self.encoder_level3, self.reduce_chan_level_2(
            torch.cat([self.down2_3(enc2), skip2], dim=1)))
        skip3 = self.skip_patch_embed3(skip2)
        latent = run(self.latent, self.reduce_chan_level_3(
            torch.cat([self.down3_4(enc3), skip3], dim=1)))
        dec3 = run(self.decoder_level3, self.reduce_chan_level3(
            torch.cat([self.up4_3(latent), enc3], dim=1)))
        dec2 = run(self.decoder_level2, self.reduce_chan_level2(
            torch.cat([self.up3_2(dec3), enc2], dim=1)))
        dec1 = torch.cat([self.up2_1(dec2), enc1], dim=1)  # 2 dim, no reduce
        dec1 = run(self.refinement, run(self.decoder_level1, dec1))
        return (self.output(dec1) + x).float()
