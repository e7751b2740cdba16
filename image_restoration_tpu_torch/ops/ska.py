"""Sparse-Kernel-Aggregation dynamic convolution (LSNet SKA).

Port of image_restoration_tpu/ops/ska.py. On (B, H, W, C) ``x`` and
(B, H, W, wc, k^2) ``w``:

    o[b, i, j, c] = sum_{kh, kw} x[b, i - p + kh, j - p + kw, c]
                    * w[b, i, j, c mod wc, kh * k + kw]

a per-pixel k x k convolution whose weights vary with the batch and the
pixel and are shared by the channels c, c + wc, c + 2 wc, ... (not by
neighbouring channels), with zero padding p = (k - 1) / 2. Sums are fp32;
the result is rounded once to x's dtype.

:func:`ska_plain` is the plain PyTorch version (the JAX ``ska_xla``); the
CUDA kernel's wrapper is ``kernels/ska.py`` ``ska``. :func:`ska_bwd_plain`
is the plain version of its backward (the JAX ``ska_pallas._ska_bwd``),
which the two backward kernels of ``kernels/ska.py`` compute.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def ska_shape(x, w):
    """(B, H, W, C, wc, ks) of a valid SKA input pair; raises ValueError on
    anything else: x 4-D, w 5-D with the same (B, H, W), C a multiple of
    wc, and k^2 the square of an odd kernel size."""
    if x.dim() != 4 or w.dim() != 5 or tuple(w.shape[:3]) != tuple(x.shape[:3]):
        raise ValueError(f"ska: x must be (B, H, W, C) and w (B, H, W, wc, k^2),"
                         f" got {tuple(x.shape)} and {tuple(w.shape)}")
    b, h, wd, c = x.shape
    wc, k2 = w.shape[3], w.shape[4]
    ks = math.isqrt(k2)
    if ks * ks != k2 or ks % 2 == 0:
        raise ValueError(f"ska: k^2 = {k2} is not the square of an odd size")
    if wc == 0 or c % wc:
        raise ValueError(f"ska: C = {c} is not a multiple of wc = {wc}")
    return b, h, wd, c, wc, ks


def ska_plain(x, w):
    """The nine (k^2) shifted slices of the zero-padded x, each times its
    tap's weights tiled over the channels, summed in fp32 in tap order and
    rounded once to x's dtype."""
    b, h, wd, c, wc, ks = ska_shape(x, w)
    pad = (ks - 1) // 2
    xp = F.pad(x.float(), (0, 0, pad, pad, pad, pad))
    wf = w.float()
    out = torch.zeros((b, h, wd, c), dtype=torch.float32, device=x.device)
    for kh in range(ks):
        for kw in range(ks):
            # channel c uses weight channel c mod wc: tile, not interleave
            wk = wf[..., kh * ks + kw].repeat(1, 1, 1, c // wc)
            out += xp[:, kh:kh + h, kw:kw + wd, :] * wk
    return out.to(x.dtype)


def ska_bwd_plain(x, w, go):
    """(gx, gw), the gradients of :func:`ska_plain` at (x, w) under the
    output gradient ``go``, as the JAX ``_ska_bwd`` computes them
    (``ska_pallas.py:109-135``), in fp32 and cast to x's and w's dtypes at
    the end:

    * gx: over the k^2 taps in order, the product go * w_k (w_k tiled over
      the channels: channel c takes w[..., c mod wc, k]) shifted back by
      the tap's offset, added;
    * gw[..., c', k]: the products go[..., c' + r wc] * x shifted by tap k,
      summed over the repeats r in order.
    """
    b, h, wd, c, wc, ks = ska_shape(x, w)
    pad = (ks - 1) // 2
    reps = c // wc

    def padded(t):
        return F.pad(t, (0, 0, pad, pad, pad, pad))

    gof = go.float()
    xp = padded(x.float())
    gx = torch.zeros((b, h, wd, c), dtype=torch.float32, device=x.device)
    gw = []
    for kh in range(ks):
        for kw in range(ks):
            k = kh * ks + kw
            wk = w[..., k].float().repeat(1, 1, 1, reps)
            pp = padded(gof * wk)
            gx += pp[:, 2 * pad - kh:2 * pad - kh + h,
                     2 * pad - kw:2 * pad - kw + wd, :]
            prod = (gof * xp[:, kh:kh + h, kw:kw + wd, :]).reshape(
                b, h, wd, reps, wc)
            acc = prod[..., 0, :]
            for r in range(1, reps):
                acc = acc + prod[..., r, :]
            gw.append(acc)
    return gx.to(x.dtype), torch.stack(gw, dim=-1).to(w.dtype)


def ska(x, w, use_kernel: bool = False):
    """SKA through the CUDA kernel's wrapper (which runs :func:`ska_plain`
    on a CPU tensor) or, with ``use_kernel`` False, the plain version."""
    if use_kernel:
        from image_restoration_tpu_torch.kernels import ska as kernel

        return kernel.ska(x, w)
    return ska_plain(x, w)
