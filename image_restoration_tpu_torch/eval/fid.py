"""FID, the Frechet Inception Distance under BasicSR's protocol
(image_restoration_tpu/eval/fid.py; HOGformer-main/settingI/basicsr/
metrics/fid.py: calculate_fid :57-102, extract_inception_features :22-55).

The reference's ``load_patched_inception_v3`` imports a module its copy
does not hold, and nothing calls its FID path, so the JAX package and this
port implement the surface that works: the Frechet distance, the streamed
feature extraction and the statistics, against a pluggable
``feature_fn`` from a torch batch to (B, D) features.

The feature extractor the JAX package names is the repo's VGG16 trunk
(``eval/perceptual.py`` ``VGG16Features``). Built for FID, it is the
trunk's last tap pooled over the pixels, on the card::

    vgg = VGG16Features(taps=(15,)).to("cuda").eval()
    vgg.load_state_dict({...})  # a torchvision vgg16 .pth through
                                # vgg16_key_map, as --vgg_ckpt loads it

    @torch.inference_mode()
    def feature_fn(batch):      # (B, 3, H, W) in [0, 1]
        return vgg(batch.to("cuda"))[-1].float().mean((2, 3))

No weights are fetched: without a checkpoint the trunk keeps its seeded
random init (a valid feature metric, but not a published one). The
distance itself is float64 numpy on the host (``scipy.linalg.sqrtm``), as
in the reference.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_feature_stats(features) -> tuple[np.ndarray, np.ndarray]:
    """Sample mean and covariance (``np.cov``, rowvar False: the unbiased
    N - 1 estimator) of an (N, D) feature matrix, float64."""
    feats = np.asarray(features, dtype=np.float64)
    if feats.ndim != 2:
        feats = feats.reshape(feats.shape[0], -1)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _host(feats) -> np.ndarray:
    if isinstance(feats, torch.Tensor):
        return feats.detach().float().cpu().numpy()
    return np.asarray(feats)


def extract_features(data_generator, feature_fn, len_generator=None):
    """Streamed feature extraction (fid.py:22-55 without its device
    plumbing): ``feature_fn`` of every batch the generator yields (a torch
    tensor, or any array ``feature_fn`` takes), each batch's (B, D)
    features brought to the host. ``len_generator`` is the reference's
    progress-bar length, unused. Returns the (N, D) numpy features."""
    del len_generator
    chunks = []
    for batch in data_generator:
        feats = _host(feature_fn(batch))
        chunks.append(feats.reshape(feats.shape[0], -1))
    return np.concatenate(chunks, axis=0)


def _sqrtm(mat):
    """``scipy.linalg.sqrtm``'s matrix: scipy before 1.14 returns
    (sqrtm, errest) with ``disp=False``; later scipy dropped the tuple."""
    from scipy import linalg

    try:
        out = linalg.sqrtm(mat, disp=False)
    except TypeError:
        out = linalg.sqrtm(mat)
    return out[0] if isinstance(out, tuple) else out


def calculate_fid(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between N(mu1, sigma1) and N(mu2, sigma2):
    ``||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))`` in float64. A
    product whose square root is not finite (singular) is retried with
    ``eps`` added to both diagonals; a complex root whose diagonal's
    imaginary part exceeds 1e-3 raises ValueError, a smaller one is
    dropped (fid.py:57-102)."""
    mu1 = np.atleast_1d(np.asarray(mu1, dtype=np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, dtype=np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, dtype=np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, dtype=np.float64))
    assert mu1.shape == mu2.shape, "Two mean vectors have different lengths"
    assert sigma1.shape == sigma2.shape, (
        "Two covariances have different dimensions")

    cov_sqrt = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(cov_sqrt).all():
        offset = np.eye(sigma1.shape[0]) * eps
        cov_sqrt = _sqrtm((sigma1 + offset) @ (sigma2 + offset))

    if np.iscomplexobj(cov_sqrt):
        if not np.allclose(np.diagonal(cov_sqrt).imag, 0, atol=1e-3):
            m = np.max(np.abs(cov_sqrt.imag))
            raise ValueError(f"Imaginary component {m}")
        cov_sqrt = cov_sqrt.real

    mean_diff = mu1 - mu2
    mean_norm = mean_diff @ mean_diff
    trace = np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(cov_sqrt)
    return float(mean_norm + trace)


def fid_from_features(feats1, feats2, eps: float = 1e-6) -> float:
    """FID between two raw feature sets, each (N, D) (numpy or torch)."""
    mu1, s1 = compute_feature_stats(_host(feats1))
    mu2, s2 = compute_feature_stats(_host(feats2))
    return calculate_fid(mu1, s1, mu2, s2, eps=eps)
