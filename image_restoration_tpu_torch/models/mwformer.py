"""MWFormer (MWFormer/model/{EncDec.py, style_filter64.py};
image_restoration_tpu/models/mwformer.py), NCHW images, (B, N, C) tokens.

* ``EncDec.py``: the TransWeather skeleton (a SegFormer encoder with
  intra-patch branches, the task-query decoder, the transposed-conv tail)
  with every encoder stage conditioned on a 64-d weather-style vector:
  ``FilmBlock`` (:22-64) cross-gating before each patch embed; hyper
  attention in stage 1 and its intra-patch block (:431-531), whose query
  and key/value projections are generated per sample from the vector by
  two-layer hypernets; a hyper MLP in every encoder block (:376-428),
  whose 3x3 depthwise kernel is generated per sample (one grouped conv
  over the batch folded into the channels, as the reference runs it);
  ``Network_top`` (:906-935) with no tanh on its output (:932-933).
* ``style_filter64.py``: ``StyleFilter_Top`` (:371-397), a two-stage
  SegFormer encoder, the upper triangles of both stages' Gram matrices,
  two MLPs and a linear layer to the 64-d vector. It trains contrastively
  (``train/recipes.py`` ``mwformer_style``) and is then frozen inside
  ``mwformer`` (``cli/train.py --style_ckpt``).

The unconditioned pieces are ``models/transweather.py``'s: PatchEmbed,
the spatial-reduction attention, Block, Tdec, ConvProjection; the encoder
is its ``Tenc`` with conditioned blocks and the FiLM blocks between
stages. Plain torch throughout (plain XLA in JAX). Attribute paths follow
the JAX tree (``backbone.Tenc.block1.0.attn.hypernet1.0.weight``); the
modules the reference defines and never calls (hyper attention's static
``q``/``kv``, the two ``layernorm``s) exist, unused, so checkpoints load.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.models.transweather import (
    Block, ConvProjection, PatchEmbed, SRAttn, Tdec, Tenc, _attend, _image,
    _Reduce, _tokens, drop_path,
)
from image_restoration_tpu_torch.ops.common import Conv, Linear, gelu_exact
from image_restoration_tpu_torch.ops.layernorm import WithBiasLayerNorm

VEC_DIM = 64  # the weather-style vector's width (style_filter64.py:338)


def _hypernet(hidden: int, out: int, dtype):
    return nn.Sequential(Linear(VEC_DIM, hidden, dtype=dtype), nn.ReLU(),
                         Linear(hidden, out, dtype=dtype))


class FilmBlock(nn.Module):
    """Cross-gating FiLM (EncDec.py:22-64): a 3x3 conv of x, and of the
    style vector a 1x1 conv, each through a LayerNorm, a linear layer and
    GELU; the vector's branch gives a per-channel weight and bias for
    x's; a linear layer and x's conv as the residual. The vector's branch
    is one pixel broadcast over the image (the reference's is a constant
    map)."""

    def __init__(self, in_ch: int, out_channels: int, dtype=None):
        super().__init__()
        c = out_channels
        self.Conv_0 = Conv(in_ch, c, 3, padding=1, dtype=dtype)
        self.Conv_1 = Conv(VEC_DIM, c, 1, dtype=dtype)
        self.LayerNorm_x = WithBiasLayerNorm(c)
        self.LayerNorm_y = WithBiasLayerNorm(c)
        for name in ("in_project_x", "in_project_y", "w_project_y",
                     "b_project_y", "out_project_x"):
            setattr(self, name, Linear(c, c, dtype=dtype))

    def forward(self, x, vec):
        x = self.Conv_0(x)
        xt = gelu_exact(self.in_project_x(self.LayerNorm_x(
            x.permute(0, 2, 3, 1))))
        y = self.Conv_1(vec[:, :, None, None]).permute(0, 2, 3, 1)
        y = gelu_exact(self.in_project_y(self.LayerNorm_y(y)))
        xt = xt * self.w_project_y(y) + self.b_project_y(y)
        return self.out_project_x(xt).permute(0, 3, 1, 2) + x


class HyperMlp(nn.Module):
    """fc1 -> a 3x3 depthwise conv whose kernel the hypernet (64 -> 3
    hidden -> 9 hidden) generates per sample -> GELU -> fc2
    (EncDec.py:376-428)."""

    def __init__(self, dim: int, hidden: int, out: int, dtype=None):
        super().__init__()
        self.hidden = hidden
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.hypernet = _hypernet(hidden * 3, hidden * 9, dtype)
        self.fc2 = Linear(hidden, out, dtype=dtype)

    def forward(self, x, h, w, vec):
        b, bc = x.shape[0], x.shape[0] * self.hidden
        xi = _image(self.fc1(x), h, w).reshape(1, bc, h, w)
        kern = self.hypernet(vec).reshape(bc, 1, 3, 3)
        xi = F.conv2d(xi, kern.to(xi.dtype), padding=1, groups=bc)
        return self.fc2(gelu_exact(_tokens(xi.reshape(b, -1, h, w))))


class HyperSRAttn(_Reduce):
    """Spatial-reduction attention whose query and key/value projection
    matrices (no biases) the hypernets (64 -> 64 -> C^2 and 2C^2) generate
    per sample (EncDec.py:431-531); fp32 logits and products, as
    ``SRAttn``. ``q`` and ``kv`` are the reference's static projections,
    which this path never calls."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, dtype=None):
        super().__init__(dim, sr_ratio, dtype)
        self.num_heads = num_heads
        self.q = Linear(dim, dim, bias=qkv_bias, dtype=dtype)
        self.hypernet1 = _hypernet(VEC_DIM, dim * dim, dtype)
        self.kv = Linear(dim, 2 * dim, bias=qkv_bias, dtype=dtype)
        self.hypernet2 = _hypernet(VEC_DIM, 2 * dim * dim, dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x, h, w, vec):
        b, n, c = x.shape
        heads = self.num_heads
        wq = self.hypernet1(vec).reshape(b, c, c).to(x.dtype)  # (out, in)
        q = torch.matmul(x, wq.transpose(1, 2))
        q = q.reshape(b, n, heads, c // heads).transpose(1, 2)
        xr = self.reduce(x, h, w)
        wkv = self.hypernet2(vec).reshape(b, 2 * c, c).to(xr.dtype)
        kv = torch.matmul(xr, wkv.transpose(1, 2))
        kv = kv.reshape(b, -1, 2, heads, c // heads)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        out = _attend(q, k, v, x.dtype)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class MWBlock(nn.Module):
    """An encoder block: the hyper or spatial-reduction attention and the
    hyper MLP, each a pre-norm residual branch under stochastic depth
    (EncDec.py:650-687)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0,
                 sr_ratio: int = 1, hyper_attn: bool = False,
                 drop_path_rate: float = 0.0, dtype=None):
        super().__init__()
        self.hyper_attn, self.drop_path_rate = hyper_attn, drop_path_rate
        attn = HyperSRAttn if hyper_attn else SRAttn
        self.norm1 = WithBiasLayerNorm(dim, 1e-6)
        self.attn = attn(dim, num_heads, sr_ratio, dtype=dtype)
        self.norm2 = WithBiasLayerNorm(dim, 1e-6)
        self.mlp = HyperMlp(dim, int(dim * mlp_ratio), dim, dtype)

    def forward(self, x, h, w, vec, train: bool = False, generator=None):
        rate = self.drop_path_rate
        a = self.norm1(x)
        a = (self.attn(a, h, w, vec) if self.hyper_attn
             else self.attn(a, h, w))
        x = x + drop_path(a, rate, train, generator)
        return x + drop_path(self.mlp(self.norm2(x), h, w, vec), rate,
                             train, generator)


class MWEnc(Tenc):
    """The FiLM-conditioned encoder (EncDec.py:66-307): ``Tenc`` with
    MWBlocks (hyper attention in stage 1 and its intra-patch block), a
    FiLM block on the input and on each stage's image before the next
    stage embeds it (the stage's output is the image before FiLM)."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 4, 4),
                 mlp_ratios: Sequence[int] = (2, 2, 2, 2),
                 depths: Sequence[int] = (2, 2, 2, 2),
                 sr_ratios: Sequence[int] = (4, 2, 2, 1),
                 drop_path_rate: float = 0.1, dtype=None):
        super().__init__(embed_dims, num_heads, mlp_ratios, depths,
                         sr_ratios, drop_path_rate, dtype, embed_dims[0])
        self.layernorm = WithBiasLayerNorm(VEC_DIM)  # unused (EncDec.py:93)
        self.input_film = FilmBlock(3, embed_dims[0], dtype)
        for i in range(3):
            setattr(self, f"film{i + 1}",
                    FilmBlock(embed_dims[i], embed_dims[i], dtype))

    @staticmethod
    def _block(dim, heads, ratio, sr_ratio, rate, stage, dtype):
        return MWBlock(dim, heads, ratio, sr_ratio, hyper_attn=stage == 0,
                       drop_path_rate=rate, dtype=dtype)

    def forward(self, x, vec, train: bool = False, generator=None):
        return self._encode(
            self.input_film(x, vec),
            dict(vec=vec, train=train, generator=generator),
            lambda i, img: getattr(self, f"film{i}")(img, vec))


def mwformer_key_map(key: str):
    """Drop the reference's ``mini_patch_embed4`` and the tail's
    ``conv_output``, which its forward never calls."""
    if ".mini_patch_embed4." in key or "convtail.conv_output" in key:
        return None
    return key


def style_filter_key_map(key: str):
    """The reference's ``encoder.block1.0...`` -> ``encoder_block1.0...``,
    ``style_filter1.hidden`` -> ``style_filter1_hidden``."""
    for a in ("encoder.", "style_filter1.", "style_filter2."):
        key = key.replace(a, a[:-1] + "_")
    return key


@register_model("mwformer_backbone", key_map=mwformer_key_map)
class MWFormerBackbone(nn.Module):
    """Network_top (EncDec.py:906-935): ``forward(x, feature_vec)``, the
    restoration conditioned on a (B, 64) style vector, fp32, no tanh. The
    widths default to the paper's configuration."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 4, 4),
                 mlp_ratios: Sequence[int] = (2, 2, 2, 2),
                 depths: Sequence[int] = (2, 2, 2, 2),
                 sr_ratios: Sequence[int] = (4, 2, 2, 1),
                 dec_depth: int = 3, dec_heads: int = 8, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.Tenc = MWEnc(tuple(embed_dims), tuple(num_heads),
                          tuple(mlp_ratios), tuple(depths), tuple(sr_ratios),
                          dtype=dtype)
        self.Tdec = Tdec(embed_dims[3], dec_heads, depth=dec_depth,
                         dtype=dtype)
        self.convtail = ConvProjection(tuple(embed_dims), dtype=dtype)
        self.clean = Conv(8, 3, 3, padding=1, dtype=dtype)

    def forward(self, x, feature_vec, train: bool = False, generator=None):
        x = x if self.dtype is None else x.to(self.dtype)
        enc = self.Tenc(x, feature_vec, train, generator)
        dec = self.Tdec(enc, train, generator)
        return self.clean(self.convtail(enc, dec)).float()


def gram_upper_vec(feat):
    """The Gram matrix of NCHW features over the pixels, its upper
    triangle (with the diagonal) flattened row-major
    (style_filter64.py:350-392): (B, C(C+1)/2)."""
    t = feat.flatten(2)
    gram = torch.matmul(t, t.transpose(1, 2))
    iu = torch.triu_indices(t.shape[1], t.shape[1], device=t.device)
    return gram[:, iu[0], iu[1]]


@register_model("mwformer_style", key_map=style_filter_key_map)
class StyleFilter(nn.Module):
    """StyleFilter_Top (style_filter64.py:371-397): a two-stage encoder
    (TransWeather's blocks), the upper triangles of both stages' Gram
    matrices through MLPs (leaky ReLU), concatenated, a linear layer to
    the (B, 64) weather-style vector, in the compute dtype."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128),
                 num_heads: Sequence[int] = (1, 2),
                 mlp_ratios: Sequence[int] = (2, 2),
                 depths: Sequence[int] = (2, 2),
                 sr_ratios: Sequence[int] = (4, 2),
                 drop_path_rate: float = 0.1, dtype=None):
        super().__init__()
        d, hd, mr, sr = embed_dims, num_heads, mlp_ratios, sr_ratios
        dpr = np.linspace(0, drop_path_rate, sum(depths))

        def ln(c):
            return WithBiasLayerNorm(c, 1e-6)

        def lin(a, b):
            return Linear(a, b, dtype=dtype)

        self.encoder_patch_embed1 = PatchEmbed(3, d[0], 7, 4, dtype)
        self.encoder_mini_patch_embed1 = PatchEmbed(d[0], d[1], 3, 2, dtype)
        self.encoder_block1 = nn.ModuleList(
            Block(d[0], hd[0], mr[0], sr[0], drop_path_rate=float(dpr[i]),
                  dtype=dtype) for i in range(depths[0]))
        self.encoder_norm1 = ln(d[0])
        self.encoder_patch_block1 = nn.ModuleList([Block(
            d[1], hd[0], mr[0], sr[0], drop_path_rate=float(dpr[0]),
            dtype=dtype)])
        self.encoder_pnorm1 = ln(d[1])
        self.encoder_patch_embed2 = PatchEmbed(d[0], d[1], 3, 2, dtype)
        self.encoder_block2 = nn.ModuleList(
            Block(d[1], hd[1], mr[1], sr[1],
                  drop_path_rate=float(dpr[depths[0] + i]), dtype=dtype)
            for i in range(depths[1]))
        self.encoder_norm2 = ln(d[1])
        g1, g2 = d[0] * (d[0] + 1) // 2, d[1] * (d[1] + 1) // 2
        self.style_filter1_hidden = lin(g1, g1 // 2)
        self.style_filter1_hidden2 = lin(g1 // 2, g1 // 4)
        self.style_filter1_output = lin(g1 // 4, VEC_DIM)
        self.style_filter2_hidden = lin(g2, g2 // 8)
        self.style_filter2_output = lin(g2 // 8, VEC_DIM)
        self.out1_fc = lin(2 * VEC_DIM, VEC_DIM)
        self.layernorm = WithBiasLayerNorm(VEC_DIM)  # unused (:380, :396)

    def forward(self, x, train: bool = False, generator=None):
        kw = dict(train=train, generator=generator)
        t, h, w = self.encoder_patch_embed1(x)
        mini, mh, mw = self.encoder_mini_patch_embed1(_image(t, h, w))
        for blk in self.encoder_block1:
            t = blk(t, h, w, **kw)
        img1 = _image(self.encoder_norm1(t), h, w)
        for blk in self.encoder_patch_block1:
            mini = blk(mini, mh, mw, **kw)
        mini = _image(self.encoder_pnorm1(mini), mh, mw)
        t, h, w = self.encoder_patch_embed2(img1)
        t = _tokens(_image(t, h, w) + mini)
        for blk in self.encoder_block2:
            t = blk(t, h, w, **kw)
        img2 = _image(self.encoder_norm2(t), h, w)
        f1 = F.leaky_relu(self.style_filter1_hidden(gram_upper_vec(img1)))
        f1 = F.leaky_relu(self.style_filter1_hidden2(f1))
        f1 = self.style_filter1_output(f1)
        f2 = F.leaky_relu(self.style_filter2_hidden(gram_upper_vec(img2)))
        f2 = self.style_filter2_output(f2)
        return self.out1_fc(torch.cat([f1, f2], dim=-1))


@register_model("mwformer", key_map=mwformer_key_map)
class MWFormer(nn.Module):
    """The style filter and the backbone end to end (MWFormer/test.py: vec
    = StyleFilter(x); out = Network_top(x, vec)), fp32 output. Training
    is two-stage: ``mwformer_style`` with the SupCon recipe, then this
    model with ``--style_ckpt``, which loads and freezes
    ``style_filter``."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 4, 4),
                 mlp_ratios: Sequence[int] = (2, 2, 2, 2),
                 depths: Sequence[int] = (2, 2, 2, 2),
                 sr_ratios: Sequence[int] = (4, 2, 2, 1),
                 dec_depth: int = 3, dec_heads: int = 8,
                 style_embed_dims: Sequence[int] = (64, 128),
                 style_depths: Sequence[int] = (2, 2), dtype=None):
        super().__init__()
        self.style_filter = StyleFilter(tuple(style_embed_dims),
                                        depths=tuple(style_depths),
                                        dtype=dtype)
        self.backbone = MWFormerBackbone(embed_dims, num_heads, mlp_ratios,
                                         depths, sr_ratios, dec_depth,
                                         dec_heads, dtype)

    def forward(self, x, train: bool = False, generator=None):
        vec = self.style_filter(x, train, generator)
        return self.backbone(x, vec, train, generator)
