"""MDTA: multi-Dconv-head transposed attention (Restormer.py:99-132), NCHW.

The attention matrix is (C/heads x C/heads), contracted over all HW pixels,
so its cost is linear in resolution. The per-channel L2 normalization over
HW commutes with the contraction,
normalize(q)^T normalize(k) = (q^T k) / (||q_c|| ||k_d||), so the logits are
the raw product rescaled by the norms (ops/attention.py in the JAX package):
no normalized copy of q or k is made.
"""

from __future__ import annotations

import torch
from torch import nn

from image_restoration_tpu_torch.ops.common import Conv


def l2_normalize(x, dim: int, eps: float = 1e-12):
    """torch F.normalize semantics: x / max(||x||_2, eps)."""
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


def normalized_channel_logits(q, k, eps: float = 1e-12):
    """Normalized C x C channel-attention logits, token-major layout
    (image_restoration_tpu/ops/attention.py ``normalized_channel_logits``).

    q, k: (B, N, heads, C) with N the token axis. Returns fp32
    (B, heads, C, C) equal to ``l2_normalize(q, dim=1)^T @
    l2_normalize(k, dim=1)``, computed as the raw contraction of the
    exactly widened activations rescaled by the outer product of the
    channel norms.
    """
    qf, kf = q.float(), k.float()
    raw = torch.einsum("bnhc,bnhd->bhcd", qf, kf)
    qn = torch.sqrt(torch.einsum("bnhc,bnhc->bhc", qf, qf))
    kn = torch.sqrt(torch.einsum("bnhc,bnhc->bhc", kf, kf))
    return raw / (torch.clamp(qn, min=eps)[..., :, None]
                  * torch.clamp(kn, min=eps)[..., None, :])


def normalized_channel_logits_tok_minor(q, k, eps: float = 1e-12):
    """:func:`normalized_channel_logits` for the token-minor layout
    (the JAX ``normalized_channel_logits_tok_minor``): q, k (..., C, N) ->
    fp32 (..., C, C)."""
    qf, kf = q.float(), k.float()
    raw = torch.matmul(qf, kf.transpose(-1, -2))
    qn = torch.sqrt((qf * qf).sum(-1))
    kn = torch.sqrt((kf * kf).sum(-1))
    return raw / (torch.clamp(qn, min=eps)[..., :, None]
                  * torch.clamp(kn, min=eps)[..., None, :])


def mdta_attention(q, k, v, temperature, num_heads: int):
    """Core MDTA contraction on NCHW q, k, v; returns NCHW in v's dtype.

    Channels are head-major ('b (head c) h w', Restormer.py:117). Products
    take operands in the activation dtype and accumulate in fp32; the norms,
    temperature and softmax are fp32, as in the JAX ``mdta_attention``.
    ``temperature`` is (heads, 1, 1), or per sample (B, heads) or (B,
    heads, 1, 1) (CG-IR's context-predicted temperature).
    """
    b, c, h, w = q.shape
    ch = c // num_heads
    dt = v.dtype

    def heads(t):  # (b, heads, ch, hw); exact widening of the activations
        return t.reshape(b, num_heads, ch, h * w).float()

    qf, kf, vf = heads(q), heads(k), heads(v)
    qn = torch.clamp(torch.sqrt((qf * qf).sum(-1)), min=1e-12)
    kn = torch.clamp(torch.sqrt((kf * kf).sum(-1)), min=1e-12)
    attn = torch.matmul(qf, kf.transpose(-1, -2))
    attn = attn / (qn[..., :, None] * kn[..., None, :])
    attn = attn * temperature.reshape(-1, num_heads, 1, 1).float()
    attn = torch.softmax(attn, dim=-1)
    out = torch.matmul(attn.to(dt).float(), vf).to(dt)
    return out.reshape(b, c, h, w)


class MDTA(nn.Module):
    """1x1 qkv conv -> 3x3 depthwise -> per-head L2-normalized channel
    attention with a learned temperature -> 1x1 projection."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False,
                 dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv(dim, dim * 3, 1, bias=bias, dtype=dtype)
        self.qkv_dwconv = Conv(dim * 3, dim * 3, 3, padding=1,
                               groups=dim * 3, bias=bias, dtype=dtype)
        self.project_out = Conv(dim, dim, 1, bias=bias, dtype=dtype)

    def forward(self, x):
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        out = mdta_attention(q, k, v, self.temperature, self.num_heads)
        return self.project_out(out)


# Sparsity levels of DRSformer's top-k attention (DRSformer_arch.py:101-173):
# each row keeps its int(ch * frac) largest logits.
TOPK_FRACS = (1 / 2, 2 / 3, 3 / 4, 4 / 5)


def topk_mixture(logits, mix):
    """sum_i mix_i * softmax(top-k_i masked logits), fp32 (.., ch, ch).

    A row keeps the logits at or above its kk-th largest, so ties keep more
    than kk, as the JAX package's threshold mask does (torch's reference
    scatters the top-k indices instead; the two agree on distinct logits).
    """
    ch = logits.shape[-1]
    out = 0.0
    for i, frac in enumerate(TOPK_FRACS):
        kk = int(ch * frac)
        thresh = torch.topk(logits, kk, dim=-1).values[..., -1:]
        masked = logits.masked_fill(logits < thresh, float("-inf"))
        out = out + torch.softmax(masked, dim=-1) * mix[i].float()
    return out


def tksa_attention(q, k, v, temperature, mix, num_heads: int):
    """Core of DRSformer's TKSA on NCHW q, k, v; returns NCHW in v's dtype.

    Logits as in :func:`mdta_attention`; the four top-k softmaxes are mixed
    by ``mix`` (attn1..attn4) before v is applied once, which is exact.
    """
    b, c, h, w = q.shape
    ch = c // num_heads
    dt = v.dtype

    def heads(t):
        return t.reshape(b, num_heads, ch, h * w).float()

    qf, kf, vf = heads(q), heads(k), heads(v)
    qn = torch.clamp(torch.sqrt((qf * qf).sum(-1)), min=1e-12)
    kn = torch.clamp(torch.sqrt((kf * kf).sum(-1)), min=1e-12)
    logits = torch.matmul(qf, kf.transpose(-1, -2))
    logits = logits / (qn[..., :, None] * kn[..., None, :])
    logits = logits * temperature.reshape(1, num_heads, 1, 1).float()
    attn = topk_mixture(logits, mix)
    out = torch.matmul(attn.to(dt).float(), vf).to(dt)
    return out.reshape(b, c, h, w)
