"""TransWeather (TransWeather-main/transweather_model.py + base_networks.py;
image_restoration_tpu/models/transweather.py), NCHW images, (B, N, C)
tokens.

A SegFormer-style encoder (four stages, overlapping patch embeds of stride
4/2/2/2, spatial-reduction attention) with intra-patch branches added into
each next stage (:138-208), a one-stage transformer decoder whose 48
learnable task queries are nearest-resized to the key/value length
(:382-450), and a tail of transposed convs and residual blocks with skips
from the encoder (:649-764), through a 3x3 conv and tanh (:825-835).

Stochastic depth: ``forward(x, train=True, generator=g)`` drops residual
branches per sample, as the JAX model does with its ``droppath`` rng; the
training CLI trains with ``train=False``, as JAX's does (its step passes
no ``droppath`` rng). Plain torch throughout (plain XLA in JAX).
Attribute paths follow the JAX tree (``Tenc.block1.0.attn.kv.weight``);
:func:`transweather_key_map` drops the reference's two modules its
forward never calls.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.common import Conv, Linear, gelu_exact
from image_restoration_tpu_torch.ops.layernorm import WithBiasLayerNorm


def drop_path(x, rate: float, train: bool, generator=None):
    """Stochastic depth over the batch (timm DropPath): each sample's
    branch kept with probability 1 - rate and scaled by 1 / (1 - rate)."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return x / keep * mask.to(x.dtype)


def _tokens(img):
    """(B, C, H, W) -> (B, H*W, C), row-major pixels."""
    return img.flatten(2).transpose(1, 2)


def _image(t, h, w):
    """(B, H*W, C) -> (B, C, H, W)."""
    return t.transpose(1, 2).reshape(t.shape[0], -1, h, w)


class PatchEmbed(nn.Module):
    """Overlapping patch embed (:215-256): conv (k, stride, pad k // 2),
    then tokens and LayerNorm. Returns (tokens, H, W)."""

    def __init__(self, in_ch: int, embed_dim: int, patch: int = 7,
                 stride: int = 4, dtype=None):
        super().__init__()
        self.proj = Conv(in_ch, embed_dim, patch, stride=stride,
                         padding=patch // 2, dtype=dtype)
        self.norm = WithBiasLayerNorm(embed_dim)

    def forward(self, x):
        x = self.proj(x)
        return self.norm(_tokens(x)), x.shape[2], x.shape[3]


def _attend(q, k, v, dtype):
    """softmax(q k^T / sqrt(d)) v over (B, heads, n, d) tensors: fp32
    logits and softmax, the weights rounded to ``dtype``, the product
    accumulated in fp32 and rounded to ``dtype`` (the JAX einsums'
    ``preferred_element_type=float32``)."""
    attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
    attn = torch.softmax(attn * q.shape[-1] ** -0.5, dim=-1).to(dtype)
    return torch.matmul(attn.float(), v.float()).to(dtype)


class _Reduce(nn.Module):
    """The spatial reduction of the keys and values: a (sr, sr) conv of
    stride sr and a LayerNorm, or nothing at sr 1."""

    def __init__(self, dim: int, sr_ratio: int, dtype=None):
        super().__init__()
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, stride=sr_ratio, dtype=dtype)
            self.norm = WithBiasLayerNorm(dim)

    def reduce(self, x, h, w):
        if self.sr_ratio == 1:
            return x
        return self.norm(_tokens(self.sr(_image(x, h, w))))


class SRAttn(_Reduce):
    """Spatial-reduction token attention (:319-380)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, dtype=None):
        super().__init__(dim, sr_ratio, dtype)
        self.num_heads = num_heads
        self.q = Linear(dim, dim, bias=qkv_bias, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x, h, w):
        b, n, c = x.shape
        heads = self.num_heads
        q = self.q(x).reshape(b, n, heads, c // heads).transpose(1, 2)
        kv = self.kv(self.reduce(x, h, w)).reshape(b, -1, 2, heads,
                                                   c // heads)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        out = _attend(q, k, v, x.dtype)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class TaskQueryAttn(_Reduce):
    """Attention_dec (:382-450): a learned bank of ``num_queries`` task
    queries (drawn from a standard normal), nearest-resized along the
    token axis to the key/value length m: query i is bank entry
    floor(i * (num_queries / m)), the quotient in fp32 (F.interpolate's
    nearest rule; JAX transweather.py:125-126)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, num_queries: int = 48, dtype=None):
        super().__init__(dim, sr_ratio, dtype)
        self.num_heads, self.dtype = num_heads, dtype
        self.task_query = nn.Parameter(torch.randn(1, num_queries, dim))
        self.q = Linear(dim, dim, bias=qkv_bias, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x, h, w):
        b, n, c = x.shape
        heads, nq = self.num_heads, self.task_query.shape[1]
        tq = self.task_query.expand(b, -1, -1).to(self.dtype or x.dtype)
        q = self.q(tq).reshape(b, nq, heads, c // heads).transpose(1, 2)
        kv = self.kv(self.reduce(x, h, w))
        m = kv.shape[1]
        kv = kv.reshape(b, m, 2, heads, c // heads)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        idx = (torch.arange(m, dtype=torch.float32, device=x.device)
               * np.float32(nq / m)).long()
        out = _attend(q[:, :, idx], k, v, x.dtype)  # m == n here
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class TokenMlp(nn.Module):
    """fc1 -> 3x3 depthwise conv on the token image -> GELU -> fc2
    (:258-316)."""

    def __init__(self, dim: int, hidden: int, out: int, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.dwconv = Conv(hidden, hidden, 3, padding=1, groups=hidden,
                           dtype=dtype)
        self.fc2 = Linear(hidden, out, dtype=dtype)

    def forward(self, x, h, w):
        x = _tokens(self.dwconv(_image(self.fc1(x), h, w)))
        return self.fc2(gelu_exact(x))


class Block(nn.Module):
    """Pre-norm token attention (SRAttn, or TaskQueryAttn in the decoder)
    and TokenMlp, each a residual branch under stochastic depth."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 sr_ratio: int = 1, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, decoder: bool = False,
                 ln_eps: float = 1e-6, dtype=None):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        attn = TaskQueryAttn if decoder else SRAttn
        self.norm1 = WithBiasLayerNorm(dim, ln_eps)
        self.attn = attn(dim, num_heads, sr_ratio, qkv_bias, dtype=dtype)
        self.norm2 = WithBiasLayerNorm(dim, ln_eps)
        self.mlp = TokenMlp(dim, int(dim * mlp_ratio), dim, dtype)

    def forward(self, x, h, w, train: bool = False, generator=None):
        rate = self.drop_path_rate
        x = x + drop_path(self.attn(self.norm1(x), h, w), rate, train,
                          generator)
        return x + drop_path(self.mlp(self.norm2(x), h, w), rate, train,
                             generator)


class Tenc(nn.Module):
    """The hierarchical encoder with intra-patch branches (:14-213).
    Returns the four stages' images."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 4, 4),
                 mlp_ratios: Sequence[int] = (2, 2, 2, 2),
                 depths: Sequence[int] = (2, 2, 2, 2),
                 sr_ratios: Sequence[int] = (4, 2, 2, 1),
                 drop_path_rate: float = 0.1, dtype=None,
                 in_chans: int = 3):
        super().__init__()
        d, hd, mr, sr = embed_dims, num_heads, mlp_ratios, sr_ratios
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cur = np.cumsum([0, *depths])
        kw = dict(dtype=dtype)

        def stage(i):
            return nn.ModuleList(
                self._block(d[i], hd[i], mr[i], sr[i],
                            float(dpr[cur[i] + j]), i, dtype)
                for j in range(depths[i]))

        def patch_block(dim, heads, ratio, sr_ratio, i):
            return nn.ModuleList([self._block(dim, heads, ratio, sr_ratio,
                                              float(dpr[cur[i]]), i, dtype)])

        self.patch_embed1 = PatchEmbed(in_chans, d[0], 7, 4, **kw)
        self.patch_embed2 = PatchEmbed(d[0], d[1], 3, 2, **kw)
        self.patch_embed3 = PatchEmbed(d[1], d[2], 3, 2, **kw)
        self.patch_embed4 = PatchEmbed(d[2], d[3], 3, 2, **kw)
        self.mini_patch_embed1 = PatchEmbed(d[0], d[1], 3, 2, **kw)
        self.mini_patch_embed2 = PatchEmbed(d[1], d[2], 3, 2, **kw)
        self.mini_patch_embed3 = PatchEmbed(d[2], d[3], 3, 2, **kw)
        self.block1, self.block2 = stage(0), stage(1)
        self.block3, self.block4 = stage(2), stage(3)
        self.patch_block1 = patch_block(d[1], hd[0], mr[0], sr[0], 0)
        self.patch_block2 = patch_block(d[2], hd[1], mr[1], sr[1], 1)
        self.patch_block3 = patch_block(d[3], hd[1], mr[2], sr[2], 2)
        for i in range(4):
            setattr(self, f"norm{i + 1}", WithBiasLayerNorm(d[i], 1e-6))
        for i in range(3):
            setattr(self, f"pnorm{i + 1}", WithBiasLayerNorm(d[i + 1], 1e-6))

    @staticmethod
    def _block(dim, heads, ratio, sr_ratio, rate, stage, dtype):
        """Block ``stage`` (0-3) of the encoder, or of its intra-patch
        branch."""
        return Block(dim, heads, ratio, sr_ratio, drop_path_rate=rate,
                     dtype=dtype)

    def forward(self, x, train: bool = False, generator=None):
        return self._encode(x, dict(train=train, generator=generator))

    def _encode(self, x, kw, film=None):
        """The four stages' images; ``kw`` goes to every block, and
        ``film(i, img)``, when given, maps stage i's image before stage i
        + 1 embeds it."""
        def run(blocks, t, h, w):
            for blk in blocks:
                t = blk(t, h, w, **kw)
            return t

        t, h, w = self.patch_embed1(x)
        mini, mh, mw = self.mini_patch_embed1(_image(t, h, w))
        outs = []
        for i in range(4):
            if i:  # the previous stage's image, plus its intra-patch branch
                prev = outs[-1] if film is None else film(i, outs[-1])
                t, h, w = getattr(self, f"patch_embed{i + 1}")(prev)
                img = _image(t, h, w) + mini_img
                if i < 3:
                    mini, mh, mw = getattr(
                        self, f"mini_patch_embed{i + 1}")(img)
                t = _tokens(img)
            t = run(getattr(self, f"block{i + 1}"), t, h, w)
            outs.append(_image(getattr(self, f"norm{i + 1}")(t), h, w))
            if i < 3:
                mini = run(getattr(self, f"patch_block{i + 1}"), mini, mh, mw)
                mini_img = _image(getattr(self, f"pnorm{i + 1}")(mini),
                                  mh, mw)
        return outs


class Tdec(nn.Module):
    """One decoder stage over the deepest encoder map (:546-647): a
    stride-2 patch embed and ``depth`` task-query blocks."""

    def __init__(self, dim: int = 512, num_heads: int = 8,
                 mlp_ratio: float = 4.0, depth: int = 3,
                 drop_path_rate: float = 0.1, dtype=None):
        super().__init__()
        dpr = np.linspace(0, drop_path_rate, 16)  # sum(depths) = 16 in ref
        self.patch_embed1 = PatchEmbed(dim, dim, 3, 2, dtype)
        self.block1 = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio, 1, drop_path_rate=float(dpr[i]),
                  decoder=True, dtype=dtype) for i in range(depth))
        self.norm1 = WithBiasLayerNorm(dim, 1e-6)

    def forward(self, feats, train: bool = False, generator=None):
        t, h, w = self.patch_embed1(feats[3])
        for blk in self.block1:
            t = blk(t, h, w, train, generator)
        return [_image(self.norm1(t), h, w)]


class ConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d(k=4, s=2, p=1)`` (base_networks.py:98)
    computing in ``dtype``, its (I, O, k, k) weight drawn as the JAX
    module's ``variance_scaling(1/3, "fan_in", "uniform")`` over its
    (k, k, O, I) kernel: uniform in +-1 / sqrt(k * k * I). Zero bias."""

    def __init__(self, in_ch: int, features: int, kernel: int = 4,
                 stride: int = 2, padding: int = 1, dtype=None):
        super().__init__(in_ch, features, kernel, stride, padding)
        self.compute_dtype = dtype

    def reset_parameters(self):
        bound = 1.0 / math.sqrt(self.in_channels * self.weight[0, 0].numel())
        with torch.no_grad():
            self.weight.uniform_(-bound, bound)
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), self.stride,
                                  self.padding)


class ResidualBlock(nn.Module):
    """x + 0.1 * conv(relu(conv(x))) (base_networks.py:108-120)."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, padding=1, dtype=dtype)
        self.conv2 = Conv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x))) * 0.1


def _crop_to_match(x, ref):
    """The reference pads with negative sizes (:667-690): a crop of the
    bottom and right edges to ``ref``'s size."""
    return x[..., : ref.shape[2], : ref.shape[3]]


class ConvProjection(nn.Module):
    """The upsampling tail with skips from the encoder (:649-712); ``dims``
    the encoder's widths, ``tail_dims`` the last two upsamplings'."""

    def __init__(self, dims: Sequence[int] = (64, 128, 320, 512),
                 tail_dims: Sequence[int] = (16, 8), dtype=None):
        super().__init__()
        d = dims
        self.convd32x = ConvTranspose(d[3], d[3], dtype=dtype)
        self.convd16x = ConvTranspose(d[3], d[2], dtype=dtype)
        self.dense_4 = nn.Sequential(ResidualBlock(d[2], dtype))
        self.convd8x = ConvTranspose(d[2], d[1], dtype=dtype)
        self.dense_3 = nn.Sequential(ResidualBlock(d[1], dtype))
        self.convd4x = ConvTranspose(d[1], d[0], dtype=dtype)
        self.dense_2 = nn.Sequential(ResidualBlock(d[0], dtype))
        self.convd2x = ConvTranspose(d[0], tail_dims[0], dtype=dtype)
        self.dense_1 = nn.Sequential(ResidualBlock(tail_dims[0], dtype))
        self.convd1x = ConvTranspose(tail_dims[0], tail_dims[1], dtype=dtype)

    def forward(self, enc, dec):
        res32 = _crop_to_match(self.convd32x(dec[0]), enc[3])
        res16 = _crop_to_match(self.convd16x(res32 + enc[3]), enc[2])
        res8 = self.convd8x(self.dense_4(res16) + enc[2])
        res4 = self.convd4x(self.dense_3(res8) + enc[1])
        res2 = self.convd2x(self.dense_2(res4) + enc[0])
        return self.convd1x(self.dense_1(res2))


def transweather_key_map(key: str):
    """Drop the reference's ``mini_patch_embed4`` (defined, never called in
    forward_features) and the tail's unused ``conv_output``."""
    if ".mini_patch_embed4." in key or key.startswith("Tenc.mini_patch_embed4"):
        return None
    if "convtail.conv_output" in key or "convproj.conv_output" in key:
        return None
    return key


@register_model("transweather", key_map=transweather_key_map)
class Transweather(nn.Module):
    """:807-846. Takes NCHW and returns tanh(conv(tail)) in [-1, 1], fp32.
    The widths default to the paper's configuration; smaller ones give a
    structurally identical net."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 4, 4),
                 mlp_ratios: Sequence[int] = (2, 2, 2, 2),
                 depths: Sequence[int] = (2, 2, 2, 2),
                 sr_ratios: Sequence[int] = (4, 2, 2, 1),
                 dec_depth: int = 3, dec_heads: int = 8,
                 tail_dims: Sequence[int] = (16, 8), dtype=None):
        super().__init__()
        self.dtype = dtype
        self.Tenc = Tenc(tuple(embed_dims), tuple(num_heads),
                         tuple(mlp_ratios), tuple(depths), tuple(sr_ratios),
                         dtype=dtype)
        self.Tdec = Tdec(embed_dims[3], dec_heads, depth=dec_depth,
                         dtype=dtype)
        self.convtail = ConvProjection(tuple(embed_dims), tuple(tail_dims),
                                       dtype)
        self.clean = Conv(tail_dims[1], 3, 3, padding=1, dtype=dtype)

    def forward(self, x, train: bool = False, generator=None):
        x = x if self.dtype is None else x.to(self.dtype)
        enc = self.Tenc(x, train, generator)
        dec = self.Tdec(enc, train, generator)
        return torch.tanh(self.clean(self.convtail(enc, dec))).float()
