"""Frequency-domain ops (image_restoration_tpu/ops/fft.py), NCHW, fp32
islands whatever the surrounding dtype.

SRConvNet's :class:`FourierUnit` (m_block.py:44-69) mixes the ortho rfft2
coefficients, real and imaginary parts interleaved per channel as torch's
``view_as_real`` lays them out, with a 1x1 conv; DarkIR's :class:`FreMLP`
(arch_model.py:36-55) runs an MLP on the rfft2 magnitude and keeps the
phase. Both take the FFT path the JAX package takes off the TPU
(``use_matmul_dft`` false): its matmul-DFT bases and four-step transform
are TPU layouts of the same function.
"""

from __future__ import annotations

import torch
from torch import nn

from image_restoration_tpu_torch.ops.common import Conv, gelu_exact


def rfft2(x, norm: str = "backward"):
    """rfft over (H, W) of NCHW ``x`` in fp32: complex64 (B, C, H, W//2+1)."""
    return torch.fft.rfft2(x.float(), norm=norm)


def irfft2(z, s, norm: str = "backward", dtype=None):
    """Inverse of :func:`rfft2` to spatial size ``s=(H, W)``, cast to
    ``dtype`` when given."""
    out = torch.fft.irfft2(z, s=tuple(s), norm=norm)
    return out.to(dtype) if dtype is not None else out


def complex_to_channels(z):
    """(B, C, H, W) complex -> (B, 2C, H, W) real, channel 2c the real and
    2c+1 the imaginary part of channel c (torch's (c, [re, im]) order)."""
    b, c, h, w = z.shape
    return torch.stack([z.real, z.imag], dim=2).reshape(b, 2 * c, h, w)


def channels_to_complex(x):
    """Inverse of :func:`complex_to_channels`."""
    b, c2, h, w = x.shape
    st = x.reshape(b, c2 // 2, 2, h, w)
    return torch.complex(st[:, :, 0], st[:, :, 1])


def _polar(re, im):
    """(sqrt(re^2 + im^2), atan2(im, re)), the JAX package's values, with
    the reference's gradient where re^2 + im^2 is 0: there its
    ``torch.abs`` and ``torch.angle`` of the complex coefficient
    differentiate to 0, while sqrt and atan2 differentiate to NaN (JAX
    fft.py:297-298 and igmoce_ir.py:101 do; a bf16 map whose rfft2 has an
    exactly zero coefficient then turns every parameter NaN in one
    update)."""
    sq = re * re + im * im
    nz = sq > 0
    one, zero = torch.ones_like(sq), torch.zeros_like(sq)
    mag = torch.where(nz, torch.sqrt(torch.where(nz, sq, one)), zero)
    pha = torch.where(nz, torch.atan2(torch.where(nz, im, zero),
                                      torch.where(nz, re, one)),
                      torch.atan2(im, re).detach())
    return mag, pha


class FourierUnit(nn.Module):
    """Ortho rfft2 -> 1x1 conv (no bias) over the interleaved real and
    imaginary channels, in the module's ``dtype`` (fp32 when None) ->
    exact GELU -> fp32 -> ortho irfft2, cast to x's dtype."""

    def __init__(self, dim: int, groups: int = 1, dtype=None):
        super().__init__()
        self.spec_dtype = dtype or torch.float32
        self.conv_layer = Conv(dim * 2, dim * 2, 1, groups=groups, bias=False,
                               dtype=self.spec_dtype)

    def forward(self, x):
        h, w = x.shape[-2:]
        f = complex_to_channels(rfft2(x, norm="ortho"))
        f = gelu_exact(self.conv_layer(f.to(self.spec_dtype))).float()
        return irfft2(channels_to_complex(f), (h, w), norm="ortho",
                      dtype=x.dtype)


class FreMLP(nn.Module):
    """An fp32 MLP on the rfft2 magnitude (``norm="backward"``), the phase
    kept: 1x1 to ``expand`` x nc, leaky ReLU 0.1, 1x1 back; irfft2 of
    m e^(i phase), cast to x's dtype. The magnitude and phase come from
    :func:`_polar`."""

    def __init__(self, nc: int, expand: int = 2, use_bias: bool = True):
        super().__init__()
        f32 = torch.float32
        self.process1 = nn.Sequential(
            Conv(nc, nc * expand, 1, bias=use_bias, dtype=f32),
            nn.LeakyReLU(0.1),
            Conv(nc * expand, nc, 1, bias=use_bias, dtype=f32))

    def forward(self, x):
        h, w = x.shape[-2:]
        z = rfft2(x, norm="backward")
        mag, pha = _polar(z.real, z.imag)
        m = self.process1(mag)
        z = torch.complex(m * torch.cos(pha), m * torch.sin(pha))
        return irfft2(z, (h, w), norm="backward", dtype=x.dtype)
