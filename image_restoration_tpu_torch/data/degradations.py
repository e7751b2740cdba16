"""Test-time Gaussian noise, reference-exact on the host
(image_restoration_tpu/data/degradations.py:15-27; the reference's
degradation_utils.py:21-24 and IRBenchmarks._add_gaussian_noise :408-411:
uint8 pixels + N(0, sigma), clip, re-quantize). The device-side batch noise
and mixup come with the training port."""

from __future__ import annotations

import numpy as np

# de_type index convention (MoCE options: denoise_15/25/50 first)
SIGMA_BY_DE_ID = {0: 15.0, 1: 25.0, 2: 50.0}


def add_gaussian_noise_np(clean_uint8: np.ndarray, sigma: float,
                          rng: np.random.Generator | None = None):
    """Reference-exact host path: clip(img + N(0,1)*sigma) on 0-255 uint8."""
    rng = rng or np.random.default_rng()
    noise = rng.standard_normal(clean_uint8.shape)
    noisy = np.clip(clean_uint8.astype(np.float64) + noise * sigma, 0, 255)
    return noisy.astype(np.uint8)
