"""Gated linear attention (GLA), the scan of ViG and HierViG
(image_restoration_tpu/ops/gla.py).

The reference imports the ``fla`` package's Triton kernels; the JAX package
computes the same recurrence with ``lax.scan`` and einsums, and so does this
module, in plain torch. Per head:

    S_t = diag(exp(gk_t)) @ S_{t-1} + k_t^T v_t        (state: d_k x d_v)
    o_t = (q_t * scale) @ S_t

with ``gk = logsigmoid(gate) / normalizer <= 0`` and ``scale = d_k^-0.5``
by default.

* :func:`recurrent_gla`: one step a token, the semantics oracle.
* :func:`chunk_gla`: the sequence in chunks of 64 (the tail padded with
  zeros). Within a chunk the causal pair term is
  ``sum_d q_id k_jd exp(G_id - G_jd)`` for j <= i, with G the inclusive
  cumsum of the gates; the state carried across chunks is the only
  sequential part: every chunk's intra-chunk output and state increment is
  computed at once, then a loop over the chunks folds the (d_k, d_v)
  states, and every chunk reads its entering state in one batched product.
* :func:`bidirectional_gla`: the forward scan plus the time-reversed one
  with the backward gates, averaged (ViG's use).

All math is fp32 whatever the input dtype, with TF32 off
(``utils/precision.py`` ``full_fp32``), and the output is cast to
``v.dtype``, as in JAX.

The intra-chunk exponent is masked before ``exp``: JAX takes
``exp(G_i - G_j)`` over the whole chunk and masks the upper triangle after
the einsum, so for j > i the exponent is positive and overflows fp32 once
the gates sum past ~88 over a chunk (forget gates of about -1.4 a token,
gate logits of about -23 after ``logsigmoid / 16``); ``inf * 0`` then
makes its output and its gradient NaN. Here ``exp(where(j <= i, G_i - G_j,
-inf))`` gives JAX's values wherever JAX is finite, and the recurrence's
(which the reference's ``fla`` kernels compute) where JAX overflows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from image_restoration_tpu_torch.utils.precision import full_fp32


def recurrent_gla(q, k, v, gk, scale: Optional[float] = None):
    """q, k, gk: (B, H, N, Dk); v: (B, H, N, Dv) -> (B, H, N, Dv), one
    step a token."""
    b, h, n, dk = q.shape
    scale = dk ** -0.5 if scale is None else scale
    with full_fp32():
        qf, kf, vf, gf = (q * scale).float(), k.float(), v.float(), gk.float()
        s = qf.new_zeros(b, h, dk, v.shape[-1])
        outs = []
        for t in range(n):
            s = (s * torch.exp(gf[:, :, t])[..., None]
                 + kf[:, :, t, :, None] * vf[:, :, t, None, :])
            outs.append(torch.einsum("bhk,bhkv->bhv", qf[:, :, t], s))
        return torch.stack(outs, dim=2).to(v.dtype)


def chunk_gla(q, k, v, gk, scale: Optional[float] = None,
              chunk_size: int = 64):
    """Chunked GLA, equal to :func:`recurrent_gla` up to fp32 rounding.
    Shapes as there."""
    b, h, n, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5 if scale is None else scale
    c = min(chunk_size, n)
    pad = (-n) % c
    nc = (n + pad) // c

    def chunks(t):  # (B, H, N, D) -> (B, H, chunks, c, D), fp32
        t = F.pad(t, (0, 0, 0, pad)) if pad else t
        return t.float().reshape(b, h, nc, c, t.shape[-1])

    with full_fp32():
        qc, kc, vc, gc = chunks(q) * scale, chunks(k), chunks(v), chunks(gk)
        g = gc.cumsum(dim=-2)  # inclusive
        causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
        diff = g[..., :, None, :] - g[..., None, :, :]  # (.., i, j, Dk)
        e = torch.exp(torch.where(causal[:, :, None], diff,
                                  float("-inf")))
        a = torch.einsum("bhnid,bhnjd,bhnijd->bhnij", qc, kc, e)
        out = a @ vc  # intra-chunk
        g_last = g[..., -1:, :]  # (B, H, chunks, 1, Dk)
        inc = (kc * torch.exp(g_last - g)).transpose(-1, -2) @ vc
        decay = torch.exp(g_last).transpose(-1, -2)  # (.., Dk, 1)
        s = qc.new_zeros(b, h, dk, dv)
        entering = []
        for i in range(nc):
            entering.append(s)
            s = s * decay[:, :, i] + inc[:, :, i]
        out = out + (qc * torch.exp(g)) @ torch.stack(entering, dim=2)
        return out.reshape(b, h, nc * c, dv)[:, :, :n].to(v.dtype)


def bidirectional_gla(q, k, v, gk_fwd, gk_bwd, scale: Optional[float] = None,
                      chunk_size: int = 64):
    """ViG's bidirectional GLA: the forward scan with the forward gates
    plus the time-reversed scan with the backward gates, halved; each in
    ``v.dtype``, as in JAX."""
    o_f = chunk_gla(q, k, v, gk_fwd, scale, chunk_size)
    flip = lambda t: t.flip(2)  # noqa: E731
    o_b = chunk_gla(flip(q), flip(k), flip(v), flip(gk_bwd), scale,
                    chunk_size)
    return (o_f + flip(o_b)) / 2
