"""Channel LayerNorms of the Restormer family, LayerNorm2d, flax's
LayerNorm (:class:`PromotingLayerNorm`), GroupNorm and BatchNorm.

The bodies normalize the last axis, as the reference's bodies do after its
``to_3d`` reshape (Restormer.py:19-70). ``LayerNorm`` takes NCHW and views it
as NHWC, which is free for the ``channels_last`` activations the models run.
Statistics are fp32 whatever the activation dtype, the variance is the biased
estimator, and the result is cast back to the input dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from image_restoration_tpu_torch.parallel import global_batch


def layer_norm_f32(x, weight, bias=None, eps: float = 1e-5):
    """LayerNorm over the last axis in fp32, returned in fp32.

    ``(x - mu) / sqrt(var + eps) * w + b``; with ``bias`` None the BiasFree
    form ``x / sqrt(var + eps) * w``, which rescales and never shifts (x is
    not centered, the variance is still taken around the mean).
    """
    xf = x.float()
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + eps)
    if bias is None:
        return xf * inv * weight.float()
    return (xf - xf.mean(dim=-1, keepdim=True)) * inv * weight.float() + bias.float()


class BiasFreeLayerNorm(nn.Module):
    """``x / sqrt(var(x) + eps) * w``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return layer_norm_f32(x, self.weight, None, self.eps).to(x.dtype)


class WithBiasLayerNorm(nn.Module):
    """``(x - mu) / sqrt(var + eps) * w + b``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm_f32(x, self.weight, self.bias, self.eps).to(x.dtype)


class PromotingLayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` with ``dtype=None`` over the last axis: fp32
    statistics with the fast variance E[x^2] - E[x]^2 (clipped at 0),
    ``(x - mu) * (rsqrt(var + eps) * w) + b`` in fp32, and the result in
    the promotion of the input's dtype and the fp32 parameters' (fp32 for a
    bf16 input, as flax returns it)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(torch.promote_types(x.dtype, torch.float32))


class LayerNorm(nn.Module):
    """The reference's ``LayerNorm(dim, LayerNorm_type)`` wrapper: the norm
    lives under ``body`` and runs over the channels of an NCHW tensor."""

    def __init__(self, dim: int, ln_type: str = "WithBias", eps: float = 1e-5):
        super().__init__()
        self.ln_type = ln_type
        cls = BiasFreeLayerNorm if ln_type == "BiasFree" else WithBiasLayerNorm
        self.body = cls(dim, eps)

    def forward(self, x):
        return self.body(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class LayerNorm2d(nn.Module):
    """The NAFNet-style channel LayerNorm (the JAX ``LayerNorm2d``, eps
    1e-6) over the channels of NCHW: fp32 statistics, biased variance,
    ``(x - mu) / sqrt(var + eps) * w + b`` in fp32, cast back to x's
    dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = layer_norm_f32(x.permute(0, 2, 3, 1), self.weight, self.bias,
                           self.eps)
        return y.to(x.dtype).permute(0, 3, 1, 2)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NCHW as flax computes it: fp32 statistics with the
    fast variance E[x^2] - E[x]^2 (clipped at 0), normalisation, scale and
    bias in fp32, one rounding to the input dtype. Groups are consecutive
    channels, as in torch."""

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.num_groups
        xf = x.permute(0, 2, 3, 1).float().reshape(b, h, w, g, c // g)
        mu = xf.mean((1, 2, 4), keepdim=True)
        var = ((xf * xf).mean((1, 2, 4), keepdim=True) - mu * mu).clamp_min(0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(g, c // g)
        y = (xf - mu) * mul + self.bias.reshape(g, c // g)
        return y.reshape(b, h, w, c).to(x.dtype).permute(0, 3, 1, 2)


class _Fp32BatchNorm:
    """torch's BatchNorm computed in fp32 whatever the activation dtype and
    cast back to it (image_restoration_tpu/ops/layernorm.py ``BatchNorm2d``).

    Eval normalises with the running statistics; train with the batch's
    (biased variance) and updates the running ones with the unbiased
    variance and ``momentum``. Parameters and buffers keep torch's names
    (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``) and stay fp32.
    """

    def forward(self, x):
        gb = global_batch.current()
        if gb is not None and self.training:
            return _global_batch_norm(self, x, gb, count=True)
        return super().forward(x.float()).to(x.dtype)


def _global_batch_norm(bn, x, gb, count: bool):
    """Train-mode BatchNorm over the global batch of a data-parallel step
    (``parallel/global_batch.py``), as flax's BatchNorm inside a sharded
    jit: fp32 statistics from the channel sums and sums of squares,
    summed over the data ranks (differentiable), the fast variance E[x^2]
    - E[x]^2 clipped at 0; the running statistics updated as torch's
    (unbiased variance, ``momentum``); ``count`` ticks
    ``num_batches_tracked`` as the module's own forward does."""
    xf = x.float()
    c = xf.shape[1]
    dims = [0] + list(range(2, xf.dim()))
    n = xf.numel() // c * gb.size
    s = gb.sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims)]))
    mean = s[:c] / n
    var = (s[c:] / n - mean * mean).clamp_min(0)
    if bn.track_running_stats and bn.running_mean is not None:
        with torch.no_grad():
            if count:
                bn.num_batches_tracked.add_(1)
            m = (bn.momentum if bn.momentum is not None
                 else 1.0 / float(bn.num_batches_tracked))
            bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            bn.running_var.mul_(1 - m).add_(
                var.detach() * (n / max(n - 1, 1)), alpha=m)
    shape = [1, c] + [1] * (xf.dim() - 2)
    y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + bn.eps)
    if bn.weight is not None:
        y = y * bn.weight.reshape(shape) + bn.bias.reshape(shape)
    return y.to(x.dtype)


class BatchNorm2d(_Fp32BatchNorm, nn.BatchNorm2d):
    """The fp32 BatchNorm over the channels of NCHW."""


def batch_norm(bn, x, train: bool):
    """``bn`` (a ``BatchNorm2d``) on ``x`` in fp32, cast back to x's dtype,
    in the mode of ``train`` rather than of the module, as the JAX
    ``BatchNorm2d`` takes it: with ``train`` from the batch's statistics
    (biased variance), updating the running ones (unbiased variance,
    ``bn.momentum``); else from the running ones. In training inside a
    data-parallel step the statistics are the global batch's
    (:func:`_global_batch_norm`)."""
    gb = global_batch.current()
    if gb is not None and train:
        return _global_batch_norm(bn, x, gb, count=False)
    return torch.nn.functional.batch_norm(
        x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
        train, bn.momentum, bn.eps).to(x.dtype)


class BatchNorm1d(_Fp32BatchNorm, nn.BatchNorm1d):
    """The fp32 BatchNorm over (B, C), LSNet's head (lsnet.py
    ``BatchNorm1d``)."""
