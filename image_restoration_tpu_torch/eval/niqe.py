"""NIQE (Natural Image Quality Evaluator), host-side numpy
(image_restoration_tpu/eval/niqe.py, of which this is the port's own copy).

Re-implemented from the behaviour of the reference BasicSR metric
(HOGformer-main/settingI/basicsr/metrics/niqe.py): MSCN normalisation with
a 7x7 Gaussian window at two scales, AGGD parameter fits of each 96x96
block's coefficients and their four pairwise-product orientations (18
features a block a scale), an MVG fit over the blocks, and the
Mahalanobis-style distance to the pristine statistics (Eq. 10, Mittal et
al. 2013).

The pristine parameters (``mu_pris_param``, ``cov_pris_param``,
``gaussian_window``) are data, not code: pass the official
``niqe_pris_params.npz`` (BasicSR ships it beside its niqe.py); the repo
ships none, and :func:`load_pris_params` raises without a path.

It is an evaluation metric over a handful of blocks, computed outside the
model's graph, as the reference and the JAX package compute it: numpy on
the host. Two properties to know when comparing scores:

* At least two 96x96 blocks are needed (``np.cov`` over the blocks), so
  images of 192x96 or more.
* The AGGD shape fit is an ``argmin`` over a table with a step of 0.001
  (:data:`_GAM`), so the score is discontinuous in the image: two images
  that differ by rounding (two restorations, one on each of two devices)
  can pick neighbouring table entries and give scores that differ by a
  table step's effect, while the same image gives the same score.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma as _gamma

_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = np.square(_gamma(2.0 / _GAM)) / (_gamma(1.0 / _GAM)
                                          * _gamma(3.0 / _GAM))


def matlab_gaussian_window(size: int = 7, sigma: float = 7 / 6):
    """fspecial('gaussian') normalised window."""
    half = (size - 1) / 2
    y, x = np.mgrid[-half: half + 1, -half: half + 1]
    w = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    return (w / w.sum()).astype(np.float64)


def estimate_aggd_param(block: np.ndarray):
    """AGGD (alpha, beta_l, beta_r) through the r-hat lookup
    (niqe.py:10-38)."""
    block = block.flatten()
    left = block[block < 0]
    right = block[block > 0]
    left_std = np.sqrt(np.mean(left ** 2)) if left.size else np.nan
    right_std = np.sqrt(np.mean(right ** 2)) if right.size else np.nan
    gammahat = left_std / right_std
    rhat = np.mean(np.abs(block)) ** 2 / np.mean(block ** 2)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / (
        (gammahat ** 2 + 1) ** 2)
    pos = np.argmin((_R_GAM - rhatnorm) ** 2)
    alpha = _GAM[pos]
    scale = np.sqrt(_gamma(1 / alpha) / _gamma(3 / alpha))
    return alpha, left_std * scale, right_std * scale


def _block_features(block: np.ndarray):
    """18 AGGD features: the block's, and its products with its four
    neighbour orientations' (niqe.py:40-65)."""
    feat = []
    alpha, bl, br = estimate_aggd_param(block)
    feat.extend([alpha, (bl + br) / 2])
    for shift in ([0, 1], [1, 0], [1, 1], [1, -1]):
        shifted = np.roll(block, shift, axis=(0, 1))
        alpha, bl, br = estimate_aggd_param(block * shifted)
        mean = (br - bl) * (_gamma(2 / alpha) / _gamma(1 / alpha))
        feat.extend([alpha, mean, bl, br])
    return feat


def _half_bilinear(img: np.ndarray):
    """cv2.INTER_LINEAR's exact 2x downsample: a 2x2 average."""
    h, w = img.shape
    h2, w2 = h // 2, w // 2
    img = img[: h2 * 2, : w2 * 2]
    return img.reshape(h2, 2, w2, 2).mean(axis=(1, 3))


def niqe(img: np.ndarray, mu_pris: np.ndarray, cov_pris: np.ndarray,
         gaussian_window: np.ndarray, block_size: int = 96) -> float:
    """img: 2-D float array in [0, 255] (the Y channel or grayscale)."""
    img = img.astype(np.float64)
    h, w = img.shape
    nbh, nbw = h // block_size, w // block_size
    img = img[: nbh * block_size, : nbw * block_size]

    distparam = []
    for scale in (1, 2):
        mu = convolve(img, gaussian_window, mode="nearest")
        sigma = np.sqrt(np.abs(
            convolve(img * img, gaussian_window, mode="nearest") - mu * mu))
        normalized = (img - mu) / (sigma + 1)
        bs = block_size // scale
        feats = []
        for iw in range(nbw):
            for ih in range(nbh):
                feats.append(_block_features(
                    normalized[ih * bs: (ih + 1) * bs,
                               iw * bs: (iw + 1) * bs]))
        distparam.append(np.asarray(feats))
        if scale == 1:
            img = _half_bilinear(img / 255.0) * 255.0

    distparam = np.concatenate(distparam, axis=1)
    mu_dist = np.nanmean(distparam, axis=0)
    clean = distparam[~np.isnan(distparam).any(axis=1)]
    cov_dist = np.cov(clean, rowvar=False)
    invcov = np.linalg.pinv((cov_pris + cov_dist) / 2)
    d = np.ravel(mu_pris) - mu_dist
    return float(np.sqrt(d @ invcov @ d))


def load_pris_params(path: str | None = None):
    """(mu_pris_param, cov_pris_param, gaussian_window) of the ``.npz`` at
    ``path``."""
    if path is None:
        raise FileNotFoundError(
            "no niqe_pris_params.npz given: pass the official file's path "
            "(--niqe_params)")
    z = np.load(path)
    return z["mu_pris_param"], z["cov_pris_param"], z["gaussian_window"]


def calculate_niqe(img: np.ndarray, crop_border: int = 0,
                   params_path: str | None = None) -> float:
    """img: HWC RGB float in [0, 1] (or 2-D, already Y, in [0, 255]),
    converted to the MATLAB Y channel as the reference converts it
    (niqe.py:158-203)."""
    mu, cov, win = load_pris_params(params_path)
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        img = (16.0 + 65.481 * r + 128.553 * g + 24.966 * b)  # MATLAB Y*255
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return niqe(img, mu, cov, win)
