"""PSNR / SSIM on the input's device, matching the reference's evaluation
protocols (image_restoration_tpu/eval/metrics.py, which is NHWC; these take
(B, C, H, W) tensors).

The zoo evaluates with three protocols (SURVEY.md §2.3 Metrics):

1. skimage: ``peak_signal_noise_ratio(data_range=1)`` and
   ``structural_similarity(gaussian_weights=True, data_range=1)``
   (AdaIR-main/utils/val_utils.py:50-65, MoCE-IR-main/src/test.py:26-52 with
   an optional validity mask for SOTS dehaze).
2. BasicSR: crop_border + optional Y-channel, 11x11 sigma-1.5 gaussian SSIM
   *without* the sample-covariance correction, on a 0-255 scale
   (HOGformer-main/settingI/basicsr/metrics/psnr_ssim.py:9-100).
3. MATLAB scripts (NeRD-Rain evaluations/*.m) — numerically protocol 2 on
   the Y channel.

Everything computes in fp32, in the JAX package's order of operations (cast,
filter, then subtract: ``ssim_yc``'s 0-255 variances cancel in fp32 there
too). The gaussian windowing is two separable depthwise convs with VALID
padding, run with TF32 off (:func:`full_fp32`), so the GPU sums in fp32 as
the CPU does; the Y transform is written out as three multiply-adds.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from image_restoration_tpu_torch.utils.precision import full_fp32

# ---------------------------------------------------------------------------
# PSNR


def psnr(pred, target, data_range: float = 1.0):
    """skimage peak_signal_noise_ratio over the whole (per-image) array.

    pred/target: (B, ...); reduces over all but the leading batch dim.
    """
    pred = pred.float()
    target = target.float()
    dims = tuple(range(1, pred.dim()))
    mse = torch.mean((pred - target) ** 2, dim=dims)
    return 10.0 * torch.log10(data_range**2 / mse)


def masked_psnr(pred, target, mask, data_range: float = 1.0):
    """MoCE-IR masked PSNR (src/test.py:27-30): sum-sq-err / sum(mask)."""
    pred = pred.float()
    target = target.float()
    dims = tuple(range(1, pred.dim()))
    err = (torch.sum((pred - target) ** 2, dim=dims)
           / torch.sum(mask.float(), dim=dims))
    return 10.0 * torch.log10(data_range**2 / err)


# ---------------------------------------------------------------------------
# SSIM


def _gaussian_kernel(win_size: int = 11, sigma: float = 1.5, device=None):
    r = (win_size - 1) // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2 * sigma**2))
    return torch.tensor(k / k.sum(), dtype=torch.float32, device=device)


def _filter2_valid(x, k1d):
    """Separable gaussian filter, VALID padding, per channel, in full fp32.
    x: (B, C, H, W)."""
    c = x.shape[1]
    win = k1d.shape[0]
    kh = k1d.reshape(1, 1, win, 1).repeat(c, 1, 1, 1)
    kw = k1d.reshape(1, 1, 1, win).repeat(c, 1, 1, 1)
    with full_fp32():
        x = F.conv2d(x, kh, groups=c)
        return F.conv2d(x, kw, groups=c)


def ssim_map(
    pred,
    target,
    data_range: float = 1.0,
    win_size: int = 11,
    sigma: float = 1.5,
    sample_covariance: bool = True,
):
    """Per-pixel SSIM map, cropped by the filter radius (B, C, H-2r, W-2r).

    sample_covariance=True reproduces skimage (cov_norm = NP/(NP-1) with
    NP=win^2); False reproduces BasicSR/MATLAB.
    """
    pred = pred.float()
    target = target.float()
    k = _gaussian_kernel(win_size, sigma, pred.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    cov_norm = (win_size**2) / (win_size**2 - 1) if sample_covariance else 1.0

    ux = _filter2_valid(pred, k)
    uy = _filter2_valid(target, k)
    uxx = _filter2_valid(pred * pred, k)
    uyy = _filter2_valid(target * target, k)
    uxy = _filter2_valid(pred * target, k)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux**2 + uy**2 + c1, vx + vy + c2
    return (a1 * a2) / (b1 * b2)


def ssim(pred, target, data_range: float = 1.0, sample_covariance: bool = True):
    """Mean SSIM per batch element (skimage protocol when sample_covariance)."""
    m = ssim_map(pred, target, data_range, sample_covariance=sample_covariance)
    return torch.mean(m, dim=tuple(range(1, m.dim())))


def masked_ssim(pred, target, mask, data_range: float = 1.0):
    """MoCE-IR compute_ssim (src/test.py:32-43): SSIM map weighted by a
    validity mask, both cropped by the filter radius, channel-mean last."""
    m = ssim_map(pred, target, data_range, sample_covariance=True)
    r = (11 - 1) // 2
    mk = mask[:, :, r:-r, r:-r].float()
    num = torch.sum(m * mk, dim=(2, 3))
    den = torch.sum(mk, dim=(2, 3))
    return torch.mean(num / den, dim=-1)


# ---------------------------------------------------------------------------
# Y-channel (BT.601, the BasicSR / MATLAB / SR protocol)


def rgb_to_y(img):
    """RGB [0,1] -> Y [0,1], (B, 3, H, W) -> (B, 1, H, W), via the 'MATLAB'
    ycbcr transform (basicsr metric_util.to_y_channel;
    SRConvNet-main/utils.py:16-63): Y = (16 + 65.481R + 128.553G + 24.966B)/255.
    """
    w = torch.tensor([65.481, 128.553, 24.966], dtype=img.dtype) / 255.0
    y = img[:, 0] * w[0] + img[:, 1] * w[1] + img[:, 2] * w[2]
    return y[:, None] + 16.0 / 255.0


def _crop_border(x, border: int):
    if border:
        x = x[:, :, border:-border, border:-border]
    return x


def psnr_yc(pred, target, crop_border: int = 0, data_range: float = 1.0):
    """Y-channel PSNR with border crop (basicsr calculate_psnr semantics)."""
    return psnr(
        _crop_border(rgb_to_y(pred), crop_border),
        _crop_border(rgb_to_y(target), crop_border),
        data_range,
    )


def ssim_yc(pred, target, crop_border: int = 0):
    """Y-channel SSIM, BasicSR/MATLAB flavor: 0-255 scale, no sample-cov."""
    p = _crop_border(rgb_to_y(pred), crop_border) * 255.0
    t = _crop_border(rgb_to_y(target), crop_border) * 255.0
    return ssim(p, t, data_range=255.0, sample_covariance=False)
