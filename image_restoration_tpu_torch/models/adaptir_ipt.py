"""IPT with AdaptIR's parameter-efficient adapters (AdaptIR-main/net/ipt.py;
image_restoration_tpu/models/adaptir_ipt.py), NCHW at the model's edges.

* :class:`IPT`: a task's conv head (a 3x3 conv and two 5x5 ``ResBlock``s),
  a :class:`VisionTransformer` body over the 3x3 patch tokens of a 48x48
  map (12 encoder and 12 decoder layers, a learned positional encoding and
  the task's learned decoder queries), the task's pixel-shuffle tail
  (x2/x3/x4 or x1), and the DIV2K mean shift at ``rgb_range`` 255, done
  functionally (the reference's frozen MeanShift convs hold no state).
* :class:`AdaptIRAdapter`: the adapter beside every FFN (:508-593): a 1x1
  head and an fp32 BatchNorm, an fp32 ortho rfft2 amplitude and phase
  branch, a low-rank (A @ B) depthwise 3x3 branch, a softmax-pooled channel
  score, the channel and spatial sigmoid gates, and a zero-initialised 1x1
  ``tail``. EDT's adapter (``models/adaptir_edt.py``) is this module with
  other divisors.

**The task.** The JAX module creates ``head_{t}``/``tail_{t}`` for the
``task_idx`` its ``__call__`` is given (default 5; the reference's tasks
are x2, x3 and x4 SR, deraining, denoising at sigma 30 and at 50). A
torch module builds
its parameters at construction, so :class:`IPT` takes ``task_idx`` as a
constructor field (default 5) and builds that task's head and tail only:
its parameters are the JAX tree's. A reference checkpoint holds all six
tasks' heads and tails; :meth:`IPT.checkpoint_key_map` drops the other
tasks' keys when one loads (as the JAX parity test's ``_filter_task``
does), and :func:`ipt_key_map` maps the rest onto the JAX tree.

The body takes exactly 48x48 inputs (its positional encoding and queries
are 256 tokens long) and raises otherwise: a larger image is served in
48x48 windows (``--tile 48``). The adapter's BatchNorm follows the
forward's ``train`` argument, as the JAX ``BatchNorm2d`` does. Attention
keeps JAX's rounding: fp32 logits and softmax, the weights rounded to the
activation dtype, A.v accumulated in fp32 and rounded. Plain torch
throughout (plain XLA in JAX). Attribute paths are the reference's
(``body.encoder.layers.0.adaptir.amp_fuse.weight``).
"""

from __future__ import annotations

import math
import re
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.common import Conv, Linear
from image_restoration_tpu_torch.ops.fft import _polar, irfft2, rfft2
from image_restoration_tpu_torch.ops.layernorm import (
    BatchNorm2d, WithBiasLayerNorm, batch_norm,
)

RGB_MEAN = (0.4488, 0.4371, 0.4040)  # DIV2K (net/common.py:18)


class ResBlock(nn.Module):
    """conv -> ReLU -> conv, plus the input (net/common.py:40-61); 5x5 in
    IPT's heads."""

    def __init__(self, n_feats: int, kernel: int = 5, dtype=None):
        super().__init__()
        self.body = nn.Sequential(
            Conv(n_feats, n_feats, kernel, padding=kernel // 2, dtype=dtype),
            nn.ReLU(),
            Conv(n_feats, n_feats, kernel, padding=kernel // 2, dtype=dtype))

    def forward(self, x):
        return x + self.body(x)


class _ChannelAffine(nn.Module):
    """The reference's per-channel 1x1 conv (``groups`` = channels) that
    scales the amplitude or the phase: ``x * weight + bias`` in fp32, with
    the (C, 1, 1, 1) weight at 1 and the bias (when ``bias``) at 0."""

    def __init__(self, c: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(c)) if bias else None

    def forward(self, x):
        x = x * self.weight.view(1, -1, 1, 1)
        return x if self.bias is None else x + self.bias.view(1, -1, 1, 1)


class AdaptIRAdapter(nn.Module):
    """AdaptIR (ipt.py:508-593) over an NCHW map of ``d_model`` channels:
    hidden = d_model // ``hidden_div`` (24 in IPT, 14 in EDT, MyModel's
    ``ffn_factor``), rank hidden // 2, the channel gate reducing by
    ``gate_div`` (8 in IPT, 4 in EDT and MyModel). Returns the
    ``d_model``-channel map the ``tail`` gives (zero at init). ``bias``
    sets the biases of every conv and dense layer but the low-rank
    kernel's and of the amplitude and phase scales, ``tail_bias`` the
    tail's: IPT's and EDT's adapters have the former and not the latter,
    MyModel's (``models/mymodel.py``) both or neither.

    The frequency branch runs in fp32 whatever the dtype: the ortho rfft2
    of the BatchNorm's output, its magnitude and phase through
    ``ops/fft.py`` ``_polar`` (JAX's abs and angle; at a zero coefficient
    the reference's gradient 0, not JAX's NaN), each scaled per channel,
    recombined and brought back by the ortho irfft2, whose absolute value
    is cast to the activation dtype. The absolute value differentiates to
    torch's subgradient 0 at 0, where JAX's gives 1."""

    def __init__(self, d_model: int, hidden_div: int = 24, gate_div: int = 8,
                 dtype=None, bias: bool = True, tail_bias: bool = False):
        super().__init__()
        hidden = d_model // hidden_div
        rank = hidden // 2
        self.hidden = hidden
        self.head = Conv(d_model, hidden, 1, bias=bias, dtype=dtype)
        self.BN = BatchNorm2d(hidden)
        self.amp_fuse = _ChannelAffine(hidden, bias)
        self.pha_fuse = _ChannelAffine(hidden, bias)
        # kaiming_uniform(a=sqrt(5)) of the (hidden, rank) and (rank, 9)
        # factors: uniform in +-1 / sqrt(shape[1]) (ipt.py:519-524)
        self.conv_weight_A = nn.Parameter(torch.empty(hidden, rank))
        self.conv_weight_B = nn.Parameter(torch.empty(rank, 9))
        self.conv_bias = nn.Parameter(torch.zeros(hidden))
        with torch.no_grad():
            for w in (self.conv_weight_A, self.conv_weight_B):
                bound = 1.0 / math.sqrt(w.shape[1])
                w.uniform_(-bound, bound)
        self.compress = Conv(hidden, 1, 1, bias=bias, dtype=dtype)
        self.proj = nn.Sequential(
            Linear(hidden, hidden // 2, bias=bias, dtype=dtype), nn.GELU(),
            Linear(hidden // 2, hidden, bias=bias, dtype=dtype))
        self.channel_interaction = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            Conv(hidden, hidden // gate_div, 1, bias=bias, dtype=dtype),
            nn.GELU(),
            Conv(hidden // gate_div, hidden, 1, bias=bias, dtype=dtype))
        self.spatial_interaction = Conv(hidden, 1, 1, bias=bias, dtype=dtype)
        self.tail = Conv(hidden, d_model, 1, bias=tail_bias, dtype=dtype)
        with torch.no_grad():
            self.tail.weight.zero_()

    def forward(self, x, train: bool = False):
        b, _, h, w = x.shape
        hid = self.hidden
        xi = batch_norm(self.BN, self.head(x), train)

        z = rfft2(xi, norm="ortho")
        mag, pha = _polar(z.real, z.imag)
        mag, pha = self.amp_fuse(mag), self.pha_fuse(pha)
        z = torch.complex(mag * torch.cos(pha), mag * torch.sin(pha))
        global_x = irfft2(z, (h, w), norm="ortho").abs().to(xi.dtype)

        wk = (self.conv_weight_A @ self.conv_weight_B).reshape(hid, 1, 3, 3)
        local_x = F.conv2d(xi, wk.to(xi.dtype), self.conv_bias.to(xi.dtype),
                           padding=1, groups=hid)

        score = torch.softmax(self.compress(xi).reshape(b, h * w, 1), dim=1)
        pooled = torch.bmm(xi.reshape(b, hid, h * w), score.to(xi.dtype))
        channel_score = self.proj(pooled[..., 0])[..., None, None]

        channel_gate = torch.sigmoid(self.channel_interaction(global_x))
        spatial_gate = torch.sigmoid(self.spatial_interaction(local_x))
        spatial_x = channel_gate * local_x + spatial_gate * global_x
        return self.tail(channel_score * spatial_x)


def _tokens_to_map(t, h, w):
    """(B, H*W, C) tokens in row-major order -> (B, C, H, W)."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def _map_to_tokens(x):
    return x.flatten(2).transpose(1, 2)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention(bias=False)``'s function (ipt.py:399): one
    packed (3C, C) ``in_proj_weight`` (xavier uniform), fp32 logits scaled
    by head_dim^-0.5 and softmax, the weights rounded to the activation
    dtype, A.v accumulated in fp32 and rounded, then ``out_proj``."""

    def __init__(self, d_model: int, num_heads: int, dtype=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = Linear(d_model, d_model, bias=False, dtype=dtype)

    def forward(self, q, k, v):
        b, lq, c = q.shape
        heads, ch = self.num_heads, c // self.num_heads
        dt = self.dtype or q.dtype
        wq, wk, wv = self.in_proj_weight.to(dt).chunk(3, dim=0)

        def split(t, wt):
            t = t.to(dt) @ wt.t()
            return t.reshape(b, -1, heads, ch).transpose(1, 2)

        qh, kh, vh = split(q, wq), split(k, wk), split(v, wv)
        attn = torch.matmul(qh.float(), kh.float().transpose(-2, -1))
        attn = torch.softmax(attn * ch ** -0.5, dim=-1).to(dt)
        out = torch.matmul(attn.float(), vh.float()).to(dt)
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, c))


class _FFNAdapted(nn.Module):
    """What both layers end with: on the normed ``t2``, linear1 -> ReLU ->
    linear2 beside the adapter; ``x + ffn + adapter``."""

    def _ffn_adapted(self, x, t2, hw, train):
        adapt = _map_to_tokens(self.adaptir(_tokens_to_map(t2, *hw), train))
        f = self.linear2(F.relu(self.linear1(t2)))
        return x + f + adapt


class EncoderLayer(_FFNAdapted):
    """Pre-norm self-attention, then the FFN with the adapter beside it on
    ``norm2``'s output (ipt.py:394-428)."""

    def __init__(self, d_model: int, num_heads: int, hidden_dim: int,
                 dtype=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, num_heads, dtype)
        self.linear1 = Linear(d_model, hidden_dim, dtype=dtype)
        self.linear2 = Linear(hidden_dim, d_model, dtype=dtype)
        self.norm1 = WithBiasLayerNorm(d_model)
        self.norm2 = WithBiasLayerNorm(d_model)
        self.adaptir = AdaptIRAdapter(d_model, dtype=dtype)

    def forward(self, src, hw, pos=None, train: bool = False):
        s2 = self.norm1(src)
        qk = s2 if pos is None else s2 + pos
        src = src + self.self_attn(qk, qk, s2)
        return self._ffn_adapted(src, self.norm2(src), hw, train)


class DecoderLayer(_FFNAdapted):
    """Self-attention with the queries' positions, cross-attention on the
    encoder's ``memory``, then the FFN with the adapter beside it on
    ``norm3``'s output (ipt.py:444-490)."""

    def __init__(self, d_model: int, num_heads: int, hidden_dim: int,
                 dtype=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, num_heads, dtype)
        self.multihead_attn = MultiheadAttention(d_model, num_heads, dtype)
        self.linear1 = Linear(d_model, hidden_dim, dtype=dtype)
        self.linear2 = Linear(hidden_dim, d_model, dtype=dtype)
        self.norm1 = WithBiasLayerNorm(d_model)
        self.norm2 = WithBiasLayerNorm(d_model)
        self.norm3 = WithBiasLayerNorm(d_model)
        self.adaptir = AdaptIRAdapter(d_model, dtype=dtype)

    def forward(self, tgt, memory, hw, query_pos, train: bool = False):
        t2 = self.norm1(tgt)
        qk = t2 + query_pos
        tgt = tgt + self.self_attn(qk, qk, t2)
        t2 = self.norm2(tgt)
        tgt = tgt + self.multihead_attn(t2 + query_pos, memory, memory)
        return self._ffn_adapted(tgt, self.norm3(tgt), hw, train)


class _Layers(nn.Module):
    """The reference's TransformerEncoder/Decoder: a ``layers`` list."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class LearnedPositionalEncoding(nn.Module):
    """The learned (tokens, dim) table under ``pe`` (drawn from a standard
    normal, as JAX's ``normal(1.0)``); the reference's ``position_ids``
    buffer is an arange and is not kept."""

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.pe = nn.Embedding(n, dim)


class VisionTransformer(nn.Module):
    """ipt.py:250-358 over a (B, C, 48, 48) map: 3x3 patch tokens with
    content ordered (c, ki, kj) as ``F.unfold`` gives it, ``linear_encoding``
    plus a residual, the positional table, ``num_layers`` encoder and
    decoder layers with the task's query row as the decoder's positions,
    the ``mlp_head`` residual and the fold back."""

    def __init__(self, img_dim: int = 48, patch_dim: int = 3,
                 num_channels: int = 64, embedding_dim: int = 576,
                 num_heads: int = 12, num_layers: int = 12,
                 hidden_dim: int = 2304, num_queries: int = 6, dtype=None):
        super().__init__()
        self.img_dim, self.patch_dim = img_dim, patch_dim
        self.embedding_dim = embedding_dim
        tokens = (img_dim // patch_dim) ** 2
        flat = num_channels * patch_dim ** 2
        self.linear_encoding = Linear(flat, embedding_dim, dtype=dtype)
        self.query_embed = nn.Embedding(num_queries, embedding_dim * tokens)
        self.position_encoding = LearnedPositionalEncoding(tokens,
                                                           embedding_dim)
        self.encoder = _Layers(
            EncoderLayer(embedding_dim, num_heads, hidden_dim, dtype)
            for _ in range(num_layers))
        self.decoder = _Layers(
            DecoderLayer(embedding_dim, num_heads, hidden_dim, dtype)
            for _ in range(num_layers))
        self.mlp_head = nn.Sequential(
            Linear(embedding_dim, hidden_dim, dtype=dtype),
            nn.Identity(),  # the reference's dropout (p=0)
            nn.ReLU(), Linear(hidden_dim, flat, dtype=dtype))

    def forward(self, x, query_idx: int, train: bool = False):
        b, c, h, w = x.shape
        if (h, w) != (self.img_dim, self.img_dim):
            raise ValueError(f"IPT's body takes {self.img_dim}x{self.img_dim} "
                             f"inputs, got {h}x{w}: serve larger images in "
                             f"{self.img_dim}x{self.img_dim} windows "
                             f"(--tile {self.img_dim})")
        p, ed = self.patch_dim, self.embedding_dim
        nh, nw = h // p, w // p
        t = F.unfold(x, p, stride=p).transpose(1, 2)  # (B, L, c*p*p)
        t = t + self.linear_encoding(t)
        qpos = self.query_embed.weight[query_idx].reshape(1, nh * nw, ed)
        qpos = qpos.to(t.dtype).expand(b, -1, -1)
        t = t + self.position_encoding.pe.weight[None].to(t.dtype)
        for layer in self.encoder.layers:
            t = layer(t, (nh, nw), train=train)
        mem = t
        for layer in self.decoder.layers:
            t = layer(t, mem, (nh, nw), qpos, train=train)
        t = t + self.mlp_head(t)
        return F.fold(t.transpose(1, 2), (h, w), p, stride=p)


def upsampler(scale: int, n_feats: int, dtype):
    """net/common.py Upsampler (IPT's tails, EDT's SR tails): conv to 4C
    and a pixel shuffle by 2, log2(s) times, or conv to 9C and a pixel
    shuffle by 3; empty at x1."""
    layers = []
    if scale in (2, 4):
        for _ in range(int(math.log2(scale))):
            layers += [Conv(n_feats, 4 * n_feats, 3, padding=1, dtype=dtype),
                       nn.PixelShuffle(2)]
    elif scale == 3:
        layers += [Conv(n_feats, 9 * n_feats, 3, padding=1, dtype=dtype),
                   nn.PixelShuffle(3)]
    elif scale != 1:
        raise ValueError(f"the tails scale by 1, 2, 3 or 4, not {scale}")
    return nn.Sequential(*layers)


_TASK_KEY = re.compile(r"(head|tail)\.(\d+)\.")
# the adapter's per-channel scales and the Sequential levels JAX flattens
# (a key of the model or of one of its modules)
_FUSE = re.compile(r"(^|\.)(amp|pha)_fuse\.(weight|bias)$")
_SEQ = re.compile(r"(^|\.)(channel_interaction|proj|mlp_head)\.(\d+)\.")
_LAYERS = re.compile(r"(^|\.)(encoder|decoder)\.layers\.")


def ipt_key_map(key: str):
    """A reference IPT key (of the model or of one of its modules) -> the
    JAX tree's (the JAX ``ipt_key_map``): the MeanShift convs and
    ``position_ids`` have no leaf (None); the two learned tables, the
    encoder and decoder lists, the fuse scales, the gates' and
    projections' Sequential indices and the MLP head are flattened."""
    if key.startswith(("sub_mean", "add_mean")) or key.endswith(
            "position_encoding.position_ids"):
        return None
    for table in ("query_embed.weight", "position_encoding.pe.weight"):
        if key.endswith(table):
            return key[:-len(table)] + table.split(".")[0]
    key = _LAYERS.sub(r"\1\2_layers.", key)
    key = _FUSE.sub(r"\1\2_fuse_\3", key)
    return _SEQ.sub(r"\1\2_\3.", key)


@register_model("ipt_adaptir", key_map=ipt_key_map)
@register_model("ipt", key_map=ipt_key_map)
class IPT(nn.Module):
    """ipt.py:48-110 for one task (``task_idx``, JAX's ``__call__``
    default 5): input and output in [0, 1], fp32 out (the reference takes
    x255 values, ipt.py:92-96); inputs of exactly 48x48."""

    def __init__(self, n_feats: int = 64,
                 scales: Sequence[int] = (2, 3, 4, 1, 1, 1),
                 rgb_range: float = 255.0, task_idx: int = 5, dtype=None):
        super().__init__()
        self.rgb_range, self.task_idx = rgb_range, task_idx
        self.register_buffer("rgb_mean", torch.tensor(RGB_MEAN).view(
            1, 3, 1, 1), persistent=False)
        t = str(task_idx)
        self.head = nn.ModuleDict({t: nn.Sequential(
            Conv(3, n_feats, 3, padding=1, dtype=dtype),
            ResBlock(n_feats, 5, dtype), ResBlock(n_feats, 5, dtype))})
        self.body = VisionTransformer(
            num_channels=n_feats, embedding_dim=n_feats * 9,
            hidden_dim=n_feats * 9 * 4, num_queries=len(scales), dtype=dtype)
        self.tail = nn.ModuleDict({t: nn.Sequential(
            upsampler(scales[task_idx], n_feats, dtype),
            Conv(n_feats, 3, 3, padding=1, dtype=dtype))})

    def checkpoint_key_map(self, key: str):
        """:func:`ipt_key_map` for this model's task: another task's head
        or tail key has no leaf here (None)."""
        m = _TASK_KEY.match(key)
        if m and int(m.group(2)) != self.task_idx:
            return None
        return ipt_key_map(key)

    def forward(self, x, train: bool = False):
        t = str(self.task_idx)
        mean = self.rgb_mean.to(x.dtype) * self.rgb_range
        x = x * self.rgb_range - mean  # sub_mean (std 1)
        h = self.head[t](x)
        res = self.body(h, self.task_idx, train=train) + h
        out = self.tail[t](res) + mean  # add_mean
        return (out / self.rgb_range).float()
