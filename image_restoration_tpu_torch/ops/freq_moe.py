"""The frequency-specialised four-expert MoE layer (reference
demo_test.py; image_restoration_tpu/ops/freq_moe.py), NCHW.

* :class:`HighFreqLocal` (:94-107): depthwise 3x3, exact GELU, depthwise
  3x3.
* :class:`LowFreqLocal` (:110-124): depthwise kxk, exact GELU, a 3x3
  average (padding counted, as flax's ``avg_pool``).
* :class:`HighFreqGlobal` (:127-174): a learnable radial gain
  ``(1 - exp(-g f)) exp(-d f)`` clipped to [0, 3] on the ortho rfft2's
  magnitude; :class:`LowFreqGlobal` (:177-224): ``exp(-d f)(1 - exp(-g
  f))`` clipped to [0, 1].
* :class:`FreqRoutingFunction` (:410-470): an image gate (GAP, Linear)
  plus a frequency-energy gate (an MLP of :func:`frequency_energy`), noisy
  top-k with the importance and load CV^2 losses in training.
* :class:`FreqAdapterLayer` (:261-357): dense dispatch of the four
  :class:`FreqModExpert`\\ s, a 1x1 out.

Two reference quirks are kept literally, as the JAX module keeps them:
the energy histogram bins the CENTRED integer grid's radii against the
unshifted spectrum, with an exclusive upper edge, so the farthest pixel
falls in no bin (:func:`frequency_energy`); and the load loss takes the
clean logits as the noisy ones (demo_test.py:454). The training noise
comes from the caller's generator through ``ops/moe.py``
``routing_noise`` and ``noisy_topk_gates(..., noise=)``. The FFT experts
take the magnitude and phase from ``ops/fft.py`` ``_polar``: the phase
only rebuilds the same coefficient, so the forward is continuous, and at a
zero coefficient the gradient is the reference's 0 where JAX's is NaN.
No Pallas kernel lies behind this layer in JAX: plain torch here.
Parameters stay fp32 and ``dtype`` is the compute dtype; the routing is
fp32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.ops import moe
from image_restoration_tpu_torch.ops.common import Conv, Linear
from image_restoration_tpu_torch.ops.fft import _polar, irfft2, rfft2


class HighFreqLocal(nn.Module):
    """Depthwise 3x3 (whatever ``kernel_size``, as the reference), exact
    GELU, depthwise 3x3."""

    def __init__(self, rank: int, kernel_size: int = 3, dtype=None):
        super().__init__()
        self.conv = nn.Sequential(
            Conv(rank, rank, 3, padding=1, groups=rank, dtype=dtype),
            nn.GELU(),
            Conv(rank, rank, 3, padding=1, groups=rank, dtype=dtype))

    def forward(self, x):
        return self.conv(x)


class LowFreqLocal(nn.Module):
    """Depthwise ``kernel_size`` conv, exact GELU, 3x3 average (stride 1,
    zero padding counted)."""

    def __init__(self, rank: int, kernel_size: int = 7, dtype=None):
        super().__init__()
        k = kernel_size
        self.conv = nn.Sequential(
            Conv(rank, rank, k, padding=k // 2, groups=rank, dtype=dtype),
            nn.GELU())

    def forward(self, x):
        return F.avg_pool2d(self.conv(x), 3, 1, 1)


_GRIDS: dict = {}


def _radial_freq_grid(h: int, w: int, device) -> torch.Tensor:
    """(H, W // 2 + 1) fp32 radial frequency of the rfft2 grid, cached per
    shape and device (a host copy each call would stall the GPU; built
    outside ``inference_mode``, so a later backward can use it)."""
    key = (h, w, str(device))
    if key not in _GRIDS:
        fy = np.fft.fftfreq(h)[:, None]
        fx = np.fft.rfftfreq(w)[None, :]
        with torch.inference_mode(False):
            _GRIDS[key] = torch.from_numpy(np.sqrt(
                fy ** 2 + fx ** 2).astype(np.float32)).to(device)
    return _GRIDS[key]


class _GlobalFilter(nn.Module):
    """The ortho rfft2's magnitude times ``filt(f)`` of the radial
    frequency, the phase kept, back in x's dtype."""

    def _filter(self, f):
        raise NotImplementedError

    def forward(self, x):
        h, w = x.shape[-2:]
        z = rfft2(x, norm="ortho")
        mag, pha = _polar(z.real, z.imag)
        mag = mag * self._filter(_radial_freq_grid(h, w, x.device))
        return irfft2(torch.complex(mag * torch.cos(pha),
                                    mag * torch.sin(pha)), (h, w),
                      norm="ortho", dtype=x.dtype)


class HighFreqGlobal(_GlobalFilter):
    """Gain ``clip((1 - exp(-g f)) exp(-d f), 0, 3)``; g and d learnable
    scalars starting at 2 and 0.5."""

    def __init__(self, rank: int, dtype=None):
        super().__init__()
        self.high_pass_gain = nn.Parameter(torch.tensor(2.0))
        self.low_pass_decay = nn.Parameter(torch.tensor(0.5))

    def _filter(self, f):
        return torch.clamp((1 - torch.exp(-self.high_pass_gain * f))
                           * torch.exp(-self.low_pass_decay * f), 0, 3)


class LowFreqGlobal(_GlobalFilter):
    """Gain ``clip(exp(-d f)(1 - exp(-g f)), 0, 1)``; g and d learnable
    scalars starting at 1."""

    def __init__(self, rank: int, dtype=None):
        super().__init__()
        self.low_pass_gain = nn.Parameter(torch.tensor(1.0))
        self.high_pass_decay = nn.Parameter(torch.tensor(1.0))

    def _filter(self, f):
        return torch.clamp(torch.exp(-self.high_pass_decay * f)
                           * (1 - torch.exp(-self.low_pass_gain * f)), 0, 1)


EXPERT_TYPES = (HighFreqLocal, HighFreqGlobal, LowFreqLocal, LowFreqGlobal)


class FreqModExpert(nn.Module):
    """ModExpert (demo_test.py:227-258) with a frequency body: the body of
    x projected to ``rank``, times SiLU of ``shared`` projected to
    ``rank``, projected back to ``dim``, plus x (bias-free 1x1s).
    ``shared_dim`` is the shared branch's width (flax infers it; ``dim``
    by default)."""

    def __init__(self, dim: int, rank: int, expert_cls, kernel_size: int = 3,
                 shared_dim=None, dtype=None):
        super().__init__()
        self.proj = nn.ModuleList([
            Conv(dim, rank, 1, bias=False, dtype=dtype),
            Conv(shared_dim or dim, rank, 1, bias=False, dtype=dtype),
            Conv(rank, dim, 1, bias=False, dtype=dtype)])
        if expert_cls in (HighFreqGlobal, LowFreqGlobal):
            self.body = expert_cls(rank, dtype=dtype)
        else:
            self.body = expert_cls(rank, kernel_size, dtype=dtype)

    def forward(self, x, shared):
        h = self.body(self.proj[0](x)) * F.silu(self.proj[1](shared))
        return self.proj[2](h) + x


_MASKS: dict = {}


def _energy_masks(h: int, w: int, freq_bins: int, device) -> torch.Tensor:
    """(bins, H, W) fp32 masks of the centred integer grid's radii in each
    of ``freq_bins`` equal bins from 0 to the largest radius, the upper
    edge exclusive (the largest radius is in no bin), cached per shape and
    device (outside ``inference_mode``); computed in numpy as the JAX
    module computes them."""
    key = (h, w, freq_bins, str(device))
    if key not in _MASKS:
        yy = np.arange(-(h // 2), h - h // 2, dtype=np.float32)
        xx = np.arange(-(w // 2), w - w // 2, dtype=np.float32)
        dist = np.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
        edges = np.linspace(0, dist.max(), freq_bins + 1)
        masks = np.stack([(dist >= edges[i]) & (dist < edges[i + 1])
                          for i in range(freq_bins)]).astype(np.float32)
        with torch.inference_mode(False):
            _MASKS[key] = torch.from_numpy(masks).to(device)
    return _MASKS[key]


def frequency_energy(x, freq_bins: int = 8):
    """(B, freq_bins) per-image radial energy histogram (demo_test.py:
    473-498): |fft2| of the fp32 map ("forward" norm) summed over each
    bin's mask (:func:`_energy_masks`, laid on the UNSHIFTED spectrum as
    the reference lays it), averaged over the channels."""
    _, _, h, w = x.shape
    mag = torch.fft.fft2(x.float(), norm="forward").abs()
    masks = _energy_masks(h, w, freq_bins, x.device)
    return torch.stack([(mag * m).sum((2, 3)).mean(1) for m in masks],
                       dim=1)


class FreqRoutingFunction(nn.Module):
    """demo_test.py:410-470: fp32 logits of the image gate (GAP, bias-free
    Linear, the reference's ``gate.2``) plus the frequency gate (Linear to
    ``freq_dim``, ReLU, bias-free Linear) of ``freq_emb`` (the
    :func:`frequency_energy` of x when None). ``forward`` returns (gates,
    top_idx, top_vals, aux): in eval no noise and aux 0; with ``train``
    the logits take ``routing_noise`` from ``generator`` at std 1/E, and
    aux is 0.5 x the importance loss of the clean softmax plus 0.5 x the
    load loss of (logits, logits)."""

    def __init__(self, dim: int, freq_dim: int, num_experts: int = 4,
                 k: int = 2, freq_bins: int = 8):
        super().__init__()
        self.k, self.freq_bins = k, freq_bins
        f32 = torch.float32
        self.gate = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(),
            Linear(dim, num_experts, bias=False, dtype=f32))
        self.freq_gate = nn.Sequential(
            Linear(freq_bins, freq_dim, dtype=f32), nn.ReLU(),
            Linear(freq_dim, num_experts, bias=False, dtype=f32))

    def logits(self, x, freq_emb=None):
        if freq_emb is None:
            freq_emb = frequency_energy(x, self.freq_bins)
        return self.gate(x) + self.freq_gate(freq_emb.float())

    def forward(self, x, freq_emb=None, train: bool = False,
                generator=None):
        logits = self.logits(x, freq_emb)
        e = logits.shape[-1]
        noise_std = 1.0 / e
        if not train:
            return (*moe.noisy_topk_gates(logits, self.k)[:3], 0.0)
        li = moe.importance_loss(torch.softmax(logits, dim=-1))
        ll = moe.load_loss(logits, logits, noise_std, self.k)
        noise = moe.routing_noise(logits.shape, generator, logits.device)
        gates, top_idx, top_vals, _ = moe.noisy_topk_gates(
            logits, self.k, noise_std, noise)
        return gates, top_idx, top_vals, 0.5 * li + 0.5 * ll


class FreqAdapterLayer(nn.Module):
    """New_AdapterLayer (demo_test.py:261-357), dense dispatch: every
    expert ``i`` (``EXPERT_TYPES[i % 4]``, kernel 3 + 2i, rank ``rank`` or,
    with ``rank_type`` other than "constant", dim / 2^(E-1-i)) runs on
    (x, shared), the outputs summed in expert order with their gates, then
    a bias-free 1x1. ``stage_depth`` is the reference's and unused (one
    expert a stage, ``experts.<i>.0``). ``forward(x, freq_emb, shared,
    train=False, generator=None)`` returns (out, aux)."""

    def __init__(self, dim: int, rank: int, num_experts: int = 4,
                 top_k: int = 2, stage_depth: int = 1,
                 rank_type: str = "constant", freq_dim: int = 128,
                 shared_dim=None, dtype=None):
        super().__init__()
        del stage_depth
        if rank_type == "constant":
            ranks = [rank] * num_experts
        else:
            ranks = [dim // (2 ** i) for i in range(num_experts)][::-1]
        self.routing = FreqRoutingFunction(dim, freq_dim, num_experts, top_k)
        self.experts = nn.ModuleList([nn.ModuleList([FreqModExpert(
            dim, ranks[i], EXPERT_TYPES[i % len(EXPERT_TYPES)], 3 + 2 * i,
            shared_dim, dtype)]) for i in range(num_experts)])
        self.proj_out = Conv(dim, dim, 1, bias=False, dtype=dtype)

    def forward(self, x, freq_emb, shared, train: bool = False,
                generator=None):
        gates, _, _, aux = self.routing(x, freq_emb, train=train,
                                        generator=generator)
        out = torch.zeros_like(x)
        for i, expert in enumerate(self.experts):
            eo = expert[0](x, shared)
            out = out + eo * gates[:, i, None, None, None].to(eo.dtype)
        return self.proj_out(out), aux
