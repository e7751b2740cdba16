"""ViG, the vision gated-linear-attention backbone
(image_restoration_tpu/models/vig.py).

* :class:`GatedLinearAttention`: a 3x3 depthwise ``in_proj`` (+SiLU) over
  the patch grid, with the cls token lifted out around it and spliced back
  raw; a fused qkv projection; a low-rank gate projection giving the
  forward and backward key-decay gates (``logsigmoid / 16``); the
  bidirectional GLA scan of ``ops/gla.py``; per-head RMSNorms of the scan
  output and of the local branch, blended by a sigmoid output gate; the
  output projection.
* 2D RoPE: ``2dv0`` (axial cos/sin) and ``2dv1`` (complex x/y frequency
  pairs).
* :class:`GLABlock`: RMSNorm, GLA, residual, RMSNorm, (Swi)GLU MLP,
  residual, with an optional layer scale.
* :class:`ViG`: the v1 (one conv) or v2 (two convs with a channel
  LayerNorm and SiLU between) patch embed, an optional cls token in the
  middle of the sequence, the absolute position embedding (bicubic resize
  at another grid), and an avgpool or cls-token head; ``feat`` returns the
  final token map as NCHW.

Attribute names are the reference torch model's (``patch_embed.proj``,
``blocks.N.attn.in_proj.0``, ``attn.gk_proj.1``, ``mlp.gate_proj``), so
``utils/jax_bridge.py`` carries JAX weights across with
:func:`vig_key_map`.

Parameters stay fp32; ``dtype`` is the compute dtype every conv and dense
layer casts to, as in the JAX model, with its promotions: the RMSNorms
return their input's dtype, the v2 patch embed's LayerNorm returns fp32
(flax's ``LayerNorm`` with ``dtype=None``), so the v2 stream is fp32 while
the v1 stream is in the compute dtype, and a layer scale (fp32) promotes
the stream to fp32. The logits are in the compute dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.common import Conv, Linear
from image_restoration_tpu_torch.ops.gla import bidirectional_gla
from image_restoration_tpu_torch.ops.layernorm import PromotingLayerNorm


def vig_key_map(key: str) -> str:
    """Reference torch key -> the key the JAX importer walks: the patch
    embed's ``proj`` level joins its parent (tests/test_vig_parity.py)."""
    return key.replace("patch_embed.proj", "patch_embed_proj")


class RMSNorm(nn.Module):
    """fla's RMSNorm over the last axis: ``x / sqrt(mean(x^2) + eps) * w``
    in fp32, returned in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight).to(x.dtype)


# (kind, h, w, head_dim, theta, device, dtype) -> (cos, sin): built once, as
# a host-to-device copy blocks the host
_ROPE_TABLES = {}


def _rope_tables(kind, h, w, head_dim, theta, device, dtype):
    key = (kind, h, w, head_dim, theta, device, dtype)
    if key not in _ROPE_TABLES:
        if kind == "2dv0":
            half = head_dim // 2
            freq = 1.0 / (theta ** (np.arange(0, half, 2, dtype=np.float32)
                                    / half))
            th = np.arange(h, dtype=np.float32) / h * half
            tw = np.arange(w, dtype=np.float32) / w * half
            ph = np.tile(np.outer(th, freq), (1, 2))  # (h, half)
            pw = np.tile(np.outer(tw, freq), (1, 2))
            pos = np.concatenate([
                np.broadcast_to(ph[:, None, :], (h, w, half)),
                np.broadcast_to(pw[None, :, :], (h, w, half)),
            ], axis=-1).reshape(h * w, head_dim)
            cos, sin = np.cos(pos), np.sin(pos)
        else:  # 2dv1, base size 14
            quarter = head_dim // 4
            freqs = 1.0 / (theta ** (np.arange(0, head_dim, 4,
                                               dtype=np.float32)[:quarter]
                                     / head_dim))
            pos = np.arange(h * w)
            xf = np.outer((pos % w) * (14 / w), freqs)  # (N, quarter)
            yf = np.outer((pos // w) * (14 / h), freqs)
            ang = np.stack([xf, yf], axis=-1).reshape(h * w, -1)
            cis = np.exp(1j * ang).astype(np.complex64)  # (N, half)
            cos, sin = cis.real, cis.imag
        _ROPE_TABLES[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
            for a in (cos, sin))
    return _ROPE_TABLES[key]


def rope_2dv0(t, h, w, head_dim, theta: float = 10000.0):
    """Axial cos/sin rotation of adjacent pairs; t: (B, H, N, D), the
    tables in t's dtype."""
    cos, sin = _rope_tables("2dv0", h, w, head_dim, theta, t.device,
                            t.dtype)
    tr = t.reshape(*t.shape[:-1], -1, 2)
    rot = torch.stack([-tr[..., 1], tr[..., 0]], dim=-1).reshape(t.shape)
    return t * cos + rot * sin


def rope_2dv1(t, h, w, head_dim, theta: float = 10000.0):
    """Each adjacent pair (a, b) of t (B, N, heads, D) as a + ib, times
    exp(i angle) of its x or y frequency (interleaved), in fp32; returned
    in t's dtype."""
    cos, sin = _rope_tables("2dv1", h, w, head_dim, theta, t.device,
                            torch.float32)
    tr = t.float().reshape(*t.shape[:-1], -1, 2)
    a, b = tr[..., 0], tr[..., 1]
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    out = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1)
    return out.reshape(t.shape).to(t.dtype)


def _without(t, tp):
    """t (B, L, ...) without token tp."""
    return torch.cat([t[:, :tp], t[:, tp + 1:]], dim=1)


def _splice(t, tok, tp):
    """t (B, L - 1, ...) with tok (B, 1, ...) inserted at tp."""
    return torch.cat([t[:, :tp], tok, t[:, tp:]], dim=1)


def gla_mix(xs, q, k, v, fw_gk, bw_gk, heads, hk, hv, norms, g_proj,
            normalizer, clamp_min=None, rope=None):
    """The part ViG's and HierViG's GLA share: q, k (B, L, key_dim) and v
    (B, L, value_dim) in heads (``rope`` rotates q and k, token-major
    (B, L, heads, hk), else they are reshaped), the gates
    ``logsigmoid / normalizer`` in fp32 (``clamp_min`` floors them), the
    bidirectional scan, and the scan output blended with the local branch
    ``xs`` (B, L, C) by ``sigmoid(g_proj(xs))`` after the per-head
    RMSNorms ``norms`` (g_norm, l_norm). Returns (B, L, value_dim)."""
    b, l, _ = xs.shape
    g_norm, l_norm = norms

    def heads_first(t, d):
        return t.reshape(b, l, heads, d).transpose(1, 2)

    if rope is not None:
        qh, kh = (rope(t.reshape(b, l, heads, hk)).transpose(1, 2)
                  for t in (q, k))
    else:
        qh, kh = heads_first(q, hk), heads_first(k, hk)
    gf, gb = (F.logsigmoid(heads_first(t, hk).float()) / normalizer
              for t in (fw_gk, bw_gk))
    if clamp_min is not None:
        gf, gb = gf.clamp_min(clamp_min), gb.clamp_min(clamp_min)
    o = bidirectional_gla(qh, kh, heads_first(v, hv), gf, gb)
    o = g_norm(o.transpose(1, 2))  # (B, L, heads, hv)
    local_h = l_norm(xs.reshape(b, l, heads, -1))
    g = torch.sigmoid(g_proj(xs)).reshape(b, l, heads, hv)
    return (o * g + local_h * (1 - g)).reshape(b, l, heads * hv)


class GatedLinearAttention(nn.Module):
    """The reference's bidirectional GLA (its train path), deterministic,
    on tokens (B, L, C) of an (h, w) grid, the cls token (if any) at
    ``token_position``."""

    def __init__(self, d_model: int, num_heads: int = 4,
                 expand_k: float = 0.5, expand_v: float = 1.0,
                 gate_low_rank_dim: int = 16, gate_logit_normalizer: int = 16,
                 norm_eps: float = 1e-6, rope_mode: str = "none",
                 use_act_in_conv: bool = True,
                 use_bias_in_dwconv: bool = False,
                 clamp_min: Optional[float] = None, dtype=None):
        super().__init__()
        self.key_dim = int(d_model * expand_k)
        self.value_dim = int(d_model * expand_v)
        self.num_heads = num_heads
        self.hk = self.key_dim // num_heads
        self.hv = self.value_dim // num_heads
        self.normalizer = gate_logit_normalizer
        self.rope_mode, self.clamp_min = rope_mode, clamp_min
        self.use_act_in_conv = use_act_in_conv
        c = d_model
        self.in_proj = nn.Sequential(Conv(c, c, 3, padding=1, groups=c,
                                          bias=use_bias_in_dwconv,
                                          dtype=dtype))
        self.qkv_proj = Linear(c, 2 * self.key_dim + self.value_dim,
                               bias=False, dtype=dtype)
        self.gk_proj = nn.Sequential(
            Linear(c, gate_low_rank_dim, bias=False, dtype=dtype),
            Linear(gate_low_rank_dim, 2 * self.key_dim, dtype=dtype))
        self.g_proj = Linear(c, self.value_dim, dtype=dtype)
        self.l_norm = RMSNorm(c // num_heads, norm_eps)
        self.g_norm = RMSNorm(self.hv, norm_eps)
        self.o_proj = Linear(self.value_dim, d_model, bias=False, dtype=dtype)

    def forward(self, x, patch_resolution: Tuple[int, int],
                token_position: Optional[int] = None):
        b, l, c = x.shape
        h, w = patch_resolution
        tp = None if token_position is None else token_position % l
        patches = x if tp is None else _without(x, tp)
        conv = self.in_proj[0](patches.reshape(b, h, w, c).permute(0, 3, 1, 2))
        if self.use_act_in_conv:
            conv = F.silu(conv)
        conv = conv.permute(0, 2, 3, 1).reshape(b, h * w, c)
        xs = conv if tp is None else _splice(conv, x[:, tp:tp + 1], tp)

        q, k, v = self.qkv_proj(xs).split(
            [self.key_dim, self.key_dim, self.value_dim], dim=-1)
        fw_gk, bw_gk = self.gk_proj(xs).chunk(2, dim=-1)
        rope = None
        if self.rope_mode == "2dv0":  # (B, H, L, D) like the reference
            def rope(t):
                return rope_2dv0(t.transpose(1, 2), h, w,
                                 self.hk).transpose(1, 2)
        elif self.rope_mode == "2dv1":
            def rope(t):
                if tp is None:
                    return rope_2dv1(t, h, w, self.hk)
                # the reference's splice (vig.py:390-395): the token put
                # back at tp is the un-rotated *patch* projection now
                # there; the cls projection is dropped
                p = _without(t, tp)
                return _splice(rope_2dv1(p, h, w, self.hk),
                               p[:, tp:tp + 1], tp)
        o = gla_mix(xs, q, k, v, fw_gk, bw_gk, self.num_heads, self.hk,
                    self.hv, (self.g_norm, self.l_norm), self.g_proj,
                    self.normalizer, self.clamp_min, rope)
        return self.o_proj(o)


class GLAMLP(nn.Module):
    """SwiGLU MLP; the hidden width 8/3 x, rounded up to 256."""

    def __init__(self, hidden_size: int,
                 intermediate_size: Optional[int] = None, dtype=None):
        super().__init__()
        inter = intermediate_size
        if inter is None:
            inter = int(hidden_size * 4 * 2 / 3)
            inter = 256 * ((inter + 255) // 256)
        self.gate_proj = Linear(hidden_size, inter * 2, bias=False,
                                dtype=dtype)
        self.down_proj = Linear(inter, hidden_size, bias=False, dtype=dtype)

    def forward(self, x):
        gate, y = self.gate_proj(x).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * y)


class GLAMlpPlain(nn.Module):
    """fc1 (4x), SiLU, fc2."""

    def __init__(self, hidden_size: int, dtype=None):
        super().__init__()
        self.fc1 = Linear(hidden_size, hidden_size * 4, dtype=dtype)
        self.fc2 = Linear(hidden_size * 4, hidden_size, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class GLABlock(nn.Module):
    """RMSNorm, GLA, residual (the reference's fused prenorm-residual
    norm), RMSNorm, MLP, residual; ``init_values`` adds the layer scales
    ``gamma1``/``gamma2``."""

    def __init__(self, hidden_size: int, num_heads: int,
                 expand_k: float = 0.5, expand_v: float = 1.0,
                 rope_mode: str = "none", use_swiglu: bool = False,
                 init_values: Optional[float] = None, norm_eps: float = 1e-6,
                 dtype=None):
        super().__init__()
        self.attn_norm = RMSNorm(hidden_size, norm_eps)
        self.attn = GatedLinearAttention(hidden_size, num_heads, expand_k,
                                         expand_v, norm_eps=norm_eps,
                                         rope_mode=rope_mode, dtype=dtype)
        self.mlp_norm = RMSNorm(hidden_size, norm_eps)
        self.mlp = (GLAMLP(hidden_size, dtype=dtype) if use_swiglu
                    else GLAMlpPlain(hidden_size, dtype=dtype))
        self.gamma1 = self.gamma2 = None
        if init_values is not None:
            self.gamma1 = nn.Parameter(torch.full((hidden_size,),
                                                  float(init_values)))
            self.gamma2 = nn.Parameter(torch.full((hidden_size,),
                                                  float(init_values)))

    def forward(self, x, patch_resolution, token_position=None):
        h = self.attn(self.attn_norm(x), patch_resolution, token_position)
        if self.gamma1 is not None:
            h = h * self.gamma1
        residual = h + x
        h = self.mlp(self.mlp_norm(residual))
        if self.gamma2 is not None:
            h = h * self.gamma2
        return residual + h


class PatchEmbed(nn.Module):
    """v1: one conv of the patch size; v2: a conv of (p/2 + 1) at stride
    p/2, channel LayerNorm, SiLU, a 3x3 stride-2 conv, channel LayerNorm
    (``proj.0`` ... ``proj.4``). NCHW in, NHWC out."""

    def __init__(self, in_chans: int, dim: int, patch_size: int,
                 version: str = "v1", dtype=None):
        super().__init__()
        self.version = version
        if version == "v1":
            self.proj = Conv(in_chans, dim, patch_size, patch_size,
                             dtype=dtype)
        else:
            s = patch_size // 2
            self.proj = nn.Sequential(
                Conv(in_chans, dim // 2, s + 1, s, 1, dtype=dtype),
                PromotingLayerNorm(dim // 2), nn.SiLU(),
                Conv(dim // 2, dim, 3, 2, 1, dtype=dtype),
                PromotingLayerNorm(dim))

    def forward(self, x):
        if self.version == "v1":
            return self.proj(x).permute(0, 2, 3, 1)
        p = self.proj
        x = F.silu(p[1](p[0](x).permute(0, 2, 3, 1)))
        return p[4](p[3](x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


def resize_pos_embed(pg, hh: int, ww: int):
    """(1, g, g, D) -> (1, hh, ww, D) bicubic in fp32, as
    ``jax.image.resize(..., "cubic")``: Keys' a = -0.5, antialiased when it
    shrinks, which is ``F.interpolate``'s antialiased bicubic (its plain
    bicubic takes a = -0.75)."""
    out = F.interpolate(pg.float().permute(0, 3, 1, 2), size=(hh, ww),
                        mode="bicubic", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


@register_model("vig", key_map=vig_key_map)
class ViG(nn.Module):
    """ViG on NCHW images: logits (B, num_classes) in the compute dtype, the
    pooled feature when ``num_classes`` is 0, or with
    ``classification_mode="feat"`` the final token map (B, D, h, w).

    ``classification_mode``: ``mid_clstok`` (a cls token spliced at the
    middle of the sequence, its final state classified; the serving
    default), ``avgpool`` (no cls token, the mean token) or ``feat``.
    Defaults are ViG-T at 224^2: patch 16, depth 12, dim 192, 2 heads.
    """

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 depth: int = 12, num_heads: int = 2, embed_dim: int = 192,
                 num_classes: int = 1000,
                 classification_mode: str = "mid_clstok",
                 rope_mode: str = "none", expand_k: float = 0.5,
                 expand_v: float = 1.0, use_swiglu: bool = False,
                 if_abs_pos_embed: bool = True,
                 init_values: Optional[float] = None,
                 patch_embed_version: str = "v1", in_chans: int = 3,
                 dtype=None):
        super().__init__()
        self.img_size, self.patch_size = img_size, patch_size
        self.embed_dim, self.num_classes = embed_dim, num_classes
        self.mode = classification_mode
        self.dtype = dtype
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size,
                                      patch_embed_version, dtype)
        use_cls = classification_mode == "mid_clstok"
        self.cls_token = None
        if use_cls:
            self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
            nn.init.normal_(self.cls_token, std=0.02)
        self.pos_embed = None
        if if_abs_pos_embed:
            grid = img_size // patch_size
            self.pos_embed = nn.Parameter(torch.empty(
                1, grid * grid + int(use_cls), embed_dim))
            nn.init.normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList(
            GLABlock(embed_dim, num_heads, expand_k, expand_v, rope_mode,
                     use_swiglu, init_values, dtype=dtype)
            for _ in range(depth))
        self.norm = RMSNorm(embed_dim)
        self.head = (Linear(embed_dim, num_classes, dtype=dtype)
                     if num_classes > 0 and classification_mode != "feat"
                     else nn.Identity())

    def forward(self, x):
        b = x.shape[0]
        t = self.patch_embed(x)
        hh, ww, d = t.shape[1:]
        t = t.reshape(b, hh * ww, d)
        tp = None
        if self.cls_token is not None:
            tp = hh * ww // 2
            t = _splice(t, self.cls_token.expand(b, 1, d).to(t.dtype), tp)
        if self.pos_embed is not None:
            pe = self.pos_embed
            grid = self.img_size // self.patch_size
            if (hh, ww) != (grid, grid):
                pg = resize_pos_embed(
                    pe[:, :grid * grid].reshape(1, grid, grid, d), hh, ww)
                pe = torch.cat([pg.reshape(1, hh * ww, d),
                                pe[:, grid * grid:].float()], dim=1)
            t = t + pe.to(t.dtype)
        for blk in self.blocks:
            t = blk(t, (hh, ww), tp)
        t = self.norm(t)
        if self.mode == "feat":
            return t.reshape(b, hh, ww, d).permute(0, 3, 1, 2)
        feat = t.mean(1) if self.mode == "avgpool" else t[:, tp]
        return self.head(feat)
