"""EDT with AdaptIR's adapters (AdaptIR-main/net/edt.py;
image_restoration_tpu/models/adaptir_edt.py), NCHW at the model's edges.

* :class:`CSwinBlock` (:317-448): one qkv projection split into a
  horizontal-stripe half and a vertical-stripe half, each attending within
  rectangular windows (6x24 and 24x6) with a depthwise 3x3 LePE term on v;
  odd blocks shift the windows (``torch.roll``) under a 0/-100 additive
  mask. Then ``proj`` and the MLP (fc1, GELU, depthwise 5x5, GELU, fc2)
  with the adapter beside it.
* :class:`SwinBody` (:738-870): six RSTB stages of six blocks at embed 180,
  a final LayerNorm, a 3x3 conv and the long residual.
* :class:`EDT` (:884-1070): ``de_type`` picks the head and the tail. SR
  (``sr_N``) keeps the resolution through its ResBlockDown stages and
  ends in ResBlockSkips, a pixel-shuffle upsampler and a conv over the
  bilinear-upsampled input; denoising (``denoise_N``) and deraining
  halve it twice with strided convs and come back through transposed-conv
  UpResBlocks. DIV2K mean shift.
* :class:`AdaptIRAdapter` (:1129-1215): IPT's adapter
  (``models/adaptir_ipt.py``) with hidden = dim // 14 and the channel gate
  reducing by 4.

**Sizes.** The body's token grid must be a multiple of 24 on both sides
(the 6x24 and 24x6 windows): the input itself for SR, the input / 4 for
denoising and deraining (a multiple of 96). Other sizes raise, as in JAX
(whose docstring promises a reflect pad that its ``__call__`` does not
do): ``--pad_multiple 96`` (or 24 for SR) pads them when serving. The
shift masks are built once per shape on the host and kept on the device.

The adapters' BatchNorms follow the forward's ``train`` argument, as the
JAX ``BatchNorm2d`` does. Plain torch throughout (plain XLA in JAX).
Attribute paths are the reference's
(``body.layers.0.residual_group.blocks.1.attns.0.lepe.weight``);
:func:`edt_key_map` maps them onto the JAX tree.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models import adaptir_ipt
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.common import (
    Conv, Linear, gelu_exact, lecun_normal_,
)
from image_restoration_tpu_torch.ops.layernorm import WithBiasLayerNorm
from image_restoration_tpu_torch.ops.resample import resize_bilinear

RGB_MEAN = (0.4488, 0.4371, 0.4040)
WINDOW = (6, 24)


def _win_hw(window_size, index):
    return tuple(window_size) if index == 0 else (window_size[1],
                                                  window_size[0])


def _window_partition(x, hs, ws):
    """(B, H, W, C) -> (B * H/hs * W/ws, hs, ws, C), windows row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // hs, hs, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, hs, ws, c)


def _window_reverse(win, hs, ws, h, w):
    b = win.shape[0] // ((h // hs) * (w // ws))
    x = win.reshape(b, h // hs, w // ws, hs, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _swin_mask(h, w, hs, ws, sh, sw):
    """The 0/-100 additive mask of shifted windows (edt.py:374-405), numpy
    (nW, hs*ws, hs*ws)."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hsl in (slice(0, -hs), slice(-hs, -sh), slice(-sh, None)):
        for wsl in (slice(0, -ws), slice(-ws, -sw), slice(-sw, None)):
            img[hsl, wsl] = cnt
            cnt += 1
    m = img.reshape(h // hs, hs, w // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, hs * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# (h, w, hs, ws, sh, sw, device) -> mask: built once, as a host-to-device
# copy blocks the host
_MASKS = {}


def shift_mask(h, w, hs, ws, sh, sw, device):
    """:func:`_swin_mask` as an fp32 tensor on ``device``, cached."""
    key = (h, w, hs, ws, sh, sw, torch.device(device))
    if key not in _MASKS:
        _MASKS[key] = torch.from_numpy(_swin_mask(h, w, hs, ws, sh,
                                                  sw)).to(device)
    return _MASKS[key]


class WindowAttention(nn.Module):
    """edt.py:232-297 on one half's (B, H, W, C/2) q, k, v: rectangular
    windows, q scaled by head_dim^-0.5 in the activation dtype, fp32
    logits plus the optional mask and softmax, the weights rounded to the
    activation dtype, A.v accumulated in fp32 and rounded, plus the LePE
    depthwise 3x3 of v."""

    def __init__(self, dim: int, num_heads: int, window_size=WINDOW,
                 index: int = 0, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.hs, self.ws = _win_hw(window_size, index)
        self.lepe = Conv(dim, dim, 3, padding=1, groups=dim, dtype=dtype)

    def forward(self, q, k, v, mask=None):
        b, h, w, c = v.shape
        hs, ws, heads = self.hs, self.ws, self.num_heads
        ch, n = c // heads, hs * ws

        def to_heads(t):
            return _window_partition(t, hs, ws).reshape(-1, n, heads,
                                                        ch).transpose(1, 2)

        qh, kh = to_heads(q), to_heads(k)
        vw = _window_partition(v, hs, ws)
        lepe = self.lepe(vw.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        vh = vw.reshape(-1, n, heads, ch).transpose(1, 2)
        lh = lepe.reshape(-1, n, heads, ch).transpose(1, 2)
        attn = torch.matmul((qh * ch ** -0.5).float(),
                            kh.float().transpose(-2, -1))
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(-1, nw, heads, n, n)
                    + mask[None, :, None]).reshape(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn.float(), vh.float()).to(v.dtype) + lh
        out = out.transpose(1, 2).reshape(-1, hs, ws, c)
        return _window_reverse(out, hs, ws, h, w)


class AdaptIRAdapter(adaptir_ipt.AdaptIRAdapter):
    """edt.py:1129-1215: IPT's adapter with hidden = dim // 14 and the
    channel gate reducing by 4, on an NCHW map."""

    def __init__(self, d_model: int, dtype=None):
        super().__init__(d_model, hidden_div=14, gate_div=4, dtype=dtype)


class Mlp(nn.Module):
    """edt.py:159-179: fc1 -> GELU -> depthwise 5x5 -> GELU -> fc2 on a
    (B, H, W, C) map."""

    def __init__(self, dim: int, hidden: int, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.dwconv = Conv(hidden, hidden, 5, padding=2, groups=hidden,
                           dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        m = gelu_exact(self.fc1(x))
        m = self.dwconv(m.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.fc2(gelu_exact(m))


class CSwinBlock(nn.Module):
    """edt.py:317-448 on (B, H*W, C) tokens of an (H, W) grid."""

    def __init__(self, dim: int, num_heads: int, window_size=WINDOW,
                 shifted: bool = False, mlp_ratio: float = 2.0, dtype=None):
        super().__init__()
        self.window_size, self.shifted = tuple(window_size), shifted
        half = dim // 2
        self.norm1 = WithBiasLayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.attns = nn.ModuleList(
            WindowAttention(half, num_heads, window_size, i, dtype)
            for i in range(2))
        self.proj = Linear(dim, dim, dtype=dtype)
        self.norm2 = WithBiasLayerNorm(dim)
        self.adaptir = AdaptIRAdapter(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x, h, w, train: bool = False):
        b, l, c = x.shape
        half = c // 2
        xi = x.reshape(b, h, w, c)
        q, k, v = self.qkv(self.norm1(xi)).chunk(3, dim=-1)
        outs = []
        for idx, attn in enumerate(self.attns):
            sl = slice(0, half) if idx == 0 else slice(half, None)
            qi, ki, vi = q[..., sl], k[..., sl], v[..., sl]
            mask = None
            if self.shifted:
                hs, ws = _win_hw(self.window_size, idx)
                sh, sw = hs // 2, ws // 2
                qi, ki, vi = (torch.roll(t, (-sh, -sw), dims=(1, 2))
                              for t in (qi, ki, vi))
                mask = shift_mask(h, w, hs, ws, sh, sw, x.device)
            o = attn(qi, ki, vi, mask)
            if self.shifted:
                o = torch.roll(o, (sh, sw), dims=(1, 2))
            outs.append(o)
        xi = xi + self.proj(torch.cat(outs, dim=-1))
        xn = self.norm2(xi)
        adapt = self.adaptir(xn.permute(0, 3, 1, 2), train).permute(0, 2, 3,
                                                                    1)
        xi = xi + self.mlp(xn) + adapt
        return xi.reshape(b, l, c)


class BasicLayer(nn.Module):
    """An RSTB's ``blocks``, odd ones shifted."""

    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio, dtype):
        super().__init__()
        self.blocks = nn.ModuleList(
            CSwinBlock(dim, num_heads, window_size, i % 2 == 1, mlp_ratio,
                       dtype) for i in range(depth))


class RSTB(nn.Module):
    """A residual group: the blocks plus the stage's input."""

    def __init__(self, *args):
        super().__init__()
        self.residual_group = BasicLayer(*args)

    def forward(self, t, h, w, train: bool = False):
        res = t
        for blk in self.residual_group.blocks:
            t = blk(t, h, w, train)
        return t + res


class _PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = WithBiasLayerNorm(dim)


class SwinBody(nn.Module):
    """edt.py:738-870 on an NCHW map: the patch-embed LayerNorm, the RSTB
    stages, the final LayerNorm, a 3x3 conv and the long residual."""

    def __init__(self, embed_dim: int = 180, depths=(6,) * 6,
                 num_heads=(6,) * 6, window_size=WINDOW,
                 mlp_ratio: float = 2.0, dtype=None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.patch_embed = _PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, nh, window_size, mlp_ratio, dtype)
            for d, nh in zip(depths, num_heads))
        self.norm = WithBiasLayerNorm(embed_dim)
        self.conv_after_body = Conv(embed_dim, embed_dim, 3, padding=1,
                                    dtype=dtype)

    def forward(self, x, train: bool = False):
        b, c, h, w = x.shape
        t = self.patch_embed.norm(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        for layer in self.layers:
            t = layer(t, h, w, train)
        feat = self.norm(t).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.conv_after_body(feat) + x


class ResBlockDown(nn.Module):
    """edt.py:38-64: 1x1 shortcut plus two 3x3 convs with leaky ReLU 0.2;
    with ``down`` also the 4x4 stride-2 conv of the sum (returned first,
    the sum second as the skip)."""

    def __init__(self, in_chl: int, out_chl: int, down: bool = False,
                 dtype=None):
        super().__init__()
        self.down = down
        self.shortcut = Conv(in_chl, out_chl, 1, dtype=dtype)
        self.conv_1 = Conv(in_chl, in_chl, 3, padding=1, dtype=dtype)
        self.conv_2 = Conv(in_chl, out_chl, 3, padding=1, dtype=dtype)
        if down:
            self.conv_down = Conv(out_chl, out_chl, 4, stride=2, padding=1,
                                  bias=False, dtype=dtype)

    def forward(self, x):
        h = F.leaky_relu(self.conv_1(x), 0.2)
        h = F.leaky_relu(self.conv_2(h), 0.2) + self.shortcut(x)
        if self.down:
            return self.conv_down(h), h
        return h


class ResBlockUp(nn.Module):
    """edt.py:79-97: 1x1 shortcut plus two 3x3 convs with leaky ReLU 0.2."""

    def __init__(self, in_chl: int, out_chl: int, dtype=None):
        super().__init__()
        self.shortcut = Conv(in_chl, out_chl, 1, dtype=dtype)
        self.conv_1 = Conv(in_chl, out_chl, 3, padding=1, dtype=dtype)
        self.conv_2 = Conv(out_chl, out_chl, 3, padding=1, dtype=dtype)

    def forward(self, x):
        h = F.leaky_relu(self.conv_1(x), 0.2)
        return F.leaky_relu(self.conv_2(h), 0.2) + self.shortcut(x)


class ConvTranspose2x(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d(k=2, s=2)`` computing in ``dtype``. The JAX
    module stores its kernel (k, k, O, I), the importer's transpose of
    torch's (I, O, k, k), and draws it with ``lecun_normal`` over that
    shape (fan in O x k x k, this weight's row); zero bias."""

    def __init__(self, in_chl: int, out_chl: int, dtype=None):
        super().__init__(in_chl, out_chl, 2, stride=2)
        self.compute_dtype = dtype

    def reset_parameters(self):
        lecun_normal_(self.weight, self.bias)

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), stride=2)


class UpResBlock(nn.Module):
    """The transposed-conv 2x up, concatenated with the skip, through a
    ResBlockUp (edt.py:109-123)."""

    def __init__(self, in_chl: int, out_chl: int, dtype=None):
        super().__init__()
        self.up = ConvTranspose2x(in_chl, out_chl, dtype)
        self.block = ResBlockUp(2 * out_chl, out_chl, dtype)

    def forward(self, x, skip):
        return self.block(torch.cat([self.up(x), skip], dim=1))


class ResBlockSkip(nn.Module):
    """A 3x3 conv, concatenated with the skip, through a ResBlockUp
    (edt.py:134-148)."""

    def __init__(self, in_chl: int, out_chl: int, skip_chl: int, dtype=None):
        super().__init__()
        self.conv = Conv(in_chl, out_chl, 3, padding=1, dtype=dtype)
        self.block = ResBlockUp(out_chl + skip_chl, out_chl, dtype)

    def forward(self, x, skip):
        return self.block(torch.cat([self.conv(x), skip], dim=1))


def _task(de_type: str):
    """(head name, tail name, SR scale or 1, is SR) of ``de_type``."""
    if "sr" in de_type:
        s = int(de_type.split("_")[-1])
        return f"head_sr_x{s}", f"tail_sr_x{s}", s, True
    if "denoise" in de_type:
        nl = int(de_type.split("_")[-1])
        return f"head_dn_g{nl}", f"tail_dn_g{nl}", 1, False
    return "head_dr_H", "tail_dr_H", 1, False


_PATCH_NORM = re.compile(r"(^|\.)patch_embed\.norm\.")
_BLOCKS = re.compile(r"(^|\.)layers\.(\d+)\.residual_group\.blocks\.(\d+)\.")
_MLP = re.compile(r"(^|\.)mlp\.(fc1|fc2|dwconv)\.")


def edt_key_map(key: str):
    """A reference EDT key (of the model or of one of its modules) -> the
    JAX tree's (the JAX ``edt_key_map``): the
    ``mean`` and the ``attn_mask`` buffers have no leaf (None); the
    patch-embed norm, the RSTB and block levels, the MLP, the fuse scales
    and the adapter's Sequential indices are flattened."""
    if key == "mean" or "attn_mask" in key:
        return None
    key = _PATCH_NORM.sub(r"\1patch_embed_norm.", key)
    key = _BLOCKS.sub(r"\1layers_\2_blocks_\3.", key)
    key = _MLP.sub(r"\1mlp_\2.", key)
    key = adaptir_ipt._FUSE.sub(r"\1\2_fuse_\3", key)
    return adaptir_ipt._SEQ.sub(r"\1\2_\3.", key)


@register_model("edt_adaptir", key_map=edt_key_map)
@register_model("edt", key_map=edt_key_map)
class EDT(nn.Module):
    """edt.py:884-1070 for one task, ``de_type`` (``sr_N``, ``denoise_N``
    or ``derain``): input and output in [0, 1], fp32 out (N x the input's
    size for ``sr_N``)."""

    def __init__(self, de_type: str = "sr_2", num_feat: int = 32,
                 embed_dim: int = 180, depth: int = 2, dtype=None):
        super().__init__()
        hname, tname, scale, is_sr = _task(de_type)
        self.hname, self.tname, self.scale, self.is_sr = (hname, tname,
                                                          scale, is_sr)
        self.depth = depth
        self.register_buffer("rgb_mean", torch.tensor(RGB_MEAN).view(
            1, 3, 1, 1), persistent=False)
        nf, ed, d = num_feat, embed_dim, depth
        head = [Conv(3, nf, 3, padding=1, dtype=dtype)]
        head += [ResBlockDown(nf * 2 ** i, nf * 2 ** (i + 1), not is_sr,
                              dtype) for i in range(d)]
        head += [Conv(nf * 2 ** d, ed, 3, padding=1, dtype=dtype)]
        setattr(self, hname, nn.ModuleList(head))
        self.body = SwinBody(ed, dtype=dtype)
        tail, cin = [], ed
        for i in reversed(range(d)):
            out = nf * 2 ** (i + 1)
            tail.append(ResBlockSkip(cin, out, out, dtype) if is_sr
                        else UpResBlock(cin, out, dtype))
            cin = out
        if is_sr:
            tail.append(adaptir_ipt.upsampler(scale, cin, dtype))
        tail.append(Conv(cin, 3, 3, padding=1, dtype=dtype))
        setattr(self, tname, nn.ModuleList(tail))

    def forward(self, x, train: bool = False):
        # the windows' 24 times the head's downsampling (1 for SR)
        m = max(WINDOW) * (1 if self.is_sr else 2 ** self.depth)
        if x.shape[-2] % m or x.shape[-1] % m:
            raise ValueError(f"EDT ({self.hname}) takes sides that are "
                             f"multiples of {m}, got {tuple(x.shape[-2:])}: "
                             f"pad them (--pad_multiple {m})")
        head, tail = getattr(self, self.hname), getattr(self, self.tname)
        mean = self.rgb_mean.to(x.dtype)
        x_inp = x - mean
        h = head[0](x_inp)
        skips = []
        for blk in head[1:-1]:
            if self.is_sr:
                h = blk(h)
                skips.append(h)
            else:
                h, skip = blk(h)
                skips.append(skip)
        h = self.body(head[-1](h), train=train)
        t = h
        for j in range(self.depth):
            t = tail[j](t, skips[-j - 1])
        if self.is_sr:
            t = tail[-1](tail[self.depth](t))
            hh, ww = x_inp.shape[-2:]
            out = resize_bilinear(x_inp, hh * self.scale,
                                  ww * self.scale) + t
        else:
            out = x_inp + tail[self.depth](t)
        return (out + mean).float()
