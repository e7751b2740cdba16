"""Degradation synthesis (image_restoration_tpu/data/degradations.py).

The reference adds Gaussian noise on the host per sample
(degradation_utils.py:21-24: uint8 pixels + N(0, sigma), clip, re-quantize).
For training, the noise is synthesized on the device over the whole batch
(:func:`add_gaussian_noise`, :func:`degrade_batch`), and so is the batch
mixup (:func:`mixup_device`), drawn from a ``torch.Generator`` on the
batch's device that :func:`step_generator` seeds from (seed, step): a
resumed run draws at each step what an uninterrupted run draws, as JAX's
``fold_in(rng, step)`` gives. The draws can also be passed in, so that
tests feed both packages the same numbers. The reference-exact host path
(:func:`add_gaussian_noise_np`) is the test-time noise
(IRBenchmarks._add_gaussian_noise :408-411).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# de_type index convention (MoCE options: denoise_15/25/50 first)
SIGMA_BY_DE_ID = {0: 15.0, 1: 25.0, 2: 50.0}


def add_gaussian_noise_np(clean_uint8: np.ndarray, sigma: float,
                          rng: np.random.Generator | None = None):
    """Reference-exact host path: clip(img + N(0,1)*sigma) on 0-255 uint8."""
    rng = rng or np.random.default_rng()
    noise = rng.standard_normal(clean_uint8.shape)
    noisy = np.clip(clean_uint8.astype(np.float64) + noise * sigma, 0, 255)
    return noisy.astype(np.uint8)


def step_generator(seed: int, step: int, device, stream: int = 0):
    """A ``torch.Generator`` on ``device`` seeded from (seed, step, stream)
    alone: each step's draws do not depend on what earlier steps drew."""
    key = np.random.SeedSequence([seed, step, stream]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key[0]) << 31 | int(key[1]) >> 1)
    return gen


def add_gaussian_noise(clean01, sigma, generator=None, noise=None):
    """Batch noise on [0,1] floats (B, C, H, W); ``sigma`` a scalar or a
    (B,) tensor in 0-255 units, matching the reference's pixel-scale
    sigma. The standard normal draw comes from ``generator`` unless
    ``noise`` is given."""
    sigma = torch.as_tensor(sigma, dtype=clean01.dtype, device=clean01.device)
    if sigma.dim() == 1:
        sigma = sigma.reshape(-1, *([1] * (clean01.dim() - 1)))
    if noise is None:
        noise = torch.randn(clean01.shape, generator=generator,
                            dtype=clean01.dtype, device=clean01.device)
    return torch.clamp(clean01 + noise * sigma / 255.0, 0.0, 1.0)


def mixup_device(lq, gt, beta: float = 1.2, use_identity: bool = False,
                 generator: Optional[torch.Generator] = None,
                 lam: Optional[float] = None, perm=None,
                 identity: Optional[bool] = None):
    """Batch mixup (BasicSR Mixing_Augment, image_restoration_model.py:
    145-170): one shared lam ~ Beta(beta, beta) and one shared permutation
    mix BOTH lq and gt; with ``use_identity`` the mix is skipped with
    probability 1/(n_augments+1) = 1/2.

    The permutation is drawn on the device from ``generator``; lam and the
    identity coin on the host, from a numpy generator seeded with
    ``generator``'s seed (no read from the device). ``lam``, ``perm`` (a
    (B,) index tensor on the batch's device) and ``identity`` (True: no
    mix), where given, take the place of the draws. Runs after degradation
    synthesis, matching the reference order (feed_train_data mixes it
    :276-284).
    """
    if perm is None:
        perm = torch.randperm(lq.shape[0], generator=generator,
                              device=lq.device)
    if lam is None or (use_identity and identity is None):
        host = np.random.default_rng(generator.initial_seed())
        lam = float(host.beta(beta, beta)) if lam is None else lam
        if use_identity and identity is None:
            identity = bool(host.random() >= 0.5)
    if use_identity and identity:
        lam = 1.0
    return (lam * lq + (1 - lam) * lq[perm],
            lam * gt + (1 - lam) * gt[perm])


def degrade_batch(batch, generator=None, noise=None):
    """Apply per-sample synthetic degradations on the device.

    batch: dict with 'gt' (B, C, H, W in [0,1]) and 'sigma' (B,) where
    sigma==0 means the lq was loaded from disk (non-synthetic task) and is
    passed through unchanged. ``generator`` and ``noise`` are
    :func:`add_gaussian_noise`'s.
    """
    if "sigma" not in batch:
        return batch
    sigma = batch["sigma"]
    noisy = add_gaussian_noise(batch["gt"], sigma, generator, noise)
    lq = torch.where((sigma > 0).reshape(-1, 1, 1, 1), noisy, batch["lq"])
    out = dict(batch)
    out["lq"] = lq
    return out
