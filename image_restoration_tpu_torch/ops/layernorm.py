"""Channel LayerNorms of the Restormer family, LayerNorm2d, GroupNorm and
BatchNorm.

The bodies normalize the last axis, as the reference's bodies do after its
``to_3d`` reshape (Restormer.py:19-70). ``LayerNorm`` takes NCHW and views it
as NHWC, which is free for the ``channels_last`` activations the models run.
Statistics are fp32 whatever the activation dtype, the variance is the biased
estimator, and the result is cast back to the input dtype.
"""

from __future__ import annotations

import torch
from torch import nn


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
        return super().forward(x.float()).to(x.dtype)


class BatchNorm2d(_Fp32BatchNorm, nn.BatchNorm2d):
    """The fp32 BatchNorm over the channels of NCHW."""


def batch_norm(bn, x, train: bool):
    """``bn`` (a ``BatchNorm2d``) on ``x`` in fp32, cast back to x's dtype,
    in the mode of ``train`` rather than of the module, as the JAX
    ``BatchNorm2d`` takes it: with ``train`` from the batch's statistics
    (biased variance), updating the running ones (unbiased variance,
    ``bn.momentum``); else from the running ones."""
    return torch.nn.functional.batch_norm(
        x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
        train, bn.momentum, bn.eps).to(x.dtype)


class BatchNorm1d(_Fp32BatchNorm, nn.BatchNorm1d):
    """The fp32 BatchNorm over (B, C), LSNet's head (lsnet.py
    ``BatchNorm1d``)."""
