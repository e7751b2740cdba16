"""Restoration losses on (B, C, H, W) tensors, differentiable
(image_restoration_tpu/train/losses.py, which is NHWC).

Covers the zoo's loss inventory (SURVEY.md §2.3 Losses): L1 (default
everywhere), Charbonnier (NeRD-Rain losses.py:5-15), FFT losses in both
flavors (MoCE loss_utils.py:139-152 stacked-real/imag L1; NeRD losses.py:44-51
mean |fft diff|), Edge/Laplacian (loss_utils.py:155-190, losses.py:17-42),
PSNR loss (loss_utils.py:14-33), SSIM losses (pytorch_msssim flavor),
Focal-L1 (loss_utils.py:100-137), GAN (lsgan/bce, loss_utils.py:58-97),
Pearson correlation (HOGformer image_restoration_model.py:241-253).

FFTs run in fp32 islands over the spatial axes whatever the activation
dtype; the Laplacian's blurs pad by replication and the HOG's Sobel
filters by zeros, as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from image_restoration_tpu_torch.eval.metrics import ssim as _ssim_metric


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred, target):
    return torch.mean(torch.square(pred - target))


def smooth_l1_loss(pred, target, beta: float = 1.0):
    """torch F.smooth_l1_loss (TransWeather train.py:161)."""
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


def charbonnier_loss(pred, target, eps: float = 1e-3):
    diff = pred - target
    return torch.mean(torch.sqrt(diff * diff + eps * eps))


def psnr_loss(pred, target):
    """Negative mean-per-image PSNR (loss_utils.PSNRLoss)."""
    mse = torch.mean(torch.square(pred - target), dim=tuple(range(1, pred.dim())))
    return -torch.mean(10.0 * torch.log10(1.0 / mse))


def ssim_loss(pred, target, data_range: float = 1.0):
    """1 - SSIM (loss_utils.SSIMloss; pytorch_msssim = gaussian, no sample cov)."""
    return 1.0 - torch.mean(_ssim_metric(pred, target, data_range,
                                         sample_covariance=False))


def fft_loss(pred, target):
    """MoCE FFTLoss: L1 over stacked real/imag of rfft2 (spatial axes)."""
    pf = torch.fft.rfft2(pred.float(), dim=(-2, -1))
    tf = torch.fft.rfft2(target.float(), dim=(-2, -1))
    return 0.5 * (torch.mean(torch.abs(pf.real - tf.real))
                  + torch.mean(torch.abs(pf.imag - tf.imag)))


def fft_abs_loss(pred, target):
    """NeRD fftLoss: mean |fft2(x) - fft2(y)| (complex magnitude)."""
    d = (torch.fft.fft2(pred.float(), dim=(-2, -1))
         - torch.fft.fft2(target.float(), dim=(-2, -1)))
    return torch.mean(torch.abs(d))


def focal_l1_loss(pred, target, gamma: float = 2.0, epsilon: float = 1e-6,
                  alpha: float = 0.1):
    abs_err = torch.abs(pred - target) / alpha
    w = torch.log(1.0 + abs_err + epsilon) ** gamma
    return torch.mean(w * abs_err)


# --- Laplacian edge loss ----------------------------------------------------

_GK1D = (0.05, 0.25, 0.4, 0.25, 0.05)


def _depthwise(img, k1d, pad_mode):
    """Per-channel 5x5 filter ``outer(k1d, k1d)`` after a 2-pixel pad."""
    c = img.shape[1]
    k = torch.tensor(k1d, dtype=torch.float32, device=img.device)
    k2d = torch.outer(k, k).to(img.dtype).repeat(c, 1, 1, 1)
    return F.conv2d(F.pad(img, (2, 2, 2, 2), mode=pad_mode), k2d, groups=c)


def laplacian_highpass(x):
    """Laplacian-of-Gaussian residual (EdgeLoss.laplacian_kernel): blur with
    replicate padding, decimate by 2, zero-stuff x4, re-blur, subtract."""
    filtered = _depthwise(x, _GK1D, "replicate")
    up = torch.zeros_like(filtered)
    up[:, :, ::2, ::2] = filtered[:, :, ::2, ::2] * 4.0
    return x - _depthwise(up, _GK1D, "replicate")


def edge_loss(pred, target, criterion: str = "charbonnier"):
    lp, lt = laplacian_highpass(pred), laplacian_highpass(target)
    if criterion == "l1":
        return torch.mean(torch.abs(lp - lt))
    if criterion == "l2":
        return torch.mean(torch.square(lp - lt))
    return charbonnier_loss(lp, lt)


# --- HOG loss ---------------------------------------------------------------

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _sobel(gray, transpose: bool):
    """3x3 cross-correlation with zero padding 1. gray: (B, 1, H, W)."""
    k = torch.tensor(_SOBEL_X, dtype=gray.dtype, device=gray.device)
    k = k.t() if transpose else k
    return F.conv2d(gray, k.reshape(1, 1, 3, 3), padding=1)


def hog_features(x, nbins: int = 9, cell_size: int = 8, block_size: int = 1,
                 signed_gradient: bool = False, eps: float = 1e-8):
    """Differentiable HOG descriptor (HOGformer HOGLayer,
    HOGformer-main/settingI/basicsr/models/image_restoration_model.py:25-101).
    Rec.601 grayscale, Sobel gradients with zero pad, soft linear
    orientation binning (relu(1 - delta/bin_width)), cell_size average-pooled
    histograms, optional L2 block normalization (block_size>1, torch-unfold
    flatten order), flattened per image as torch's (B, nbins, Hc, Wc).
    x: (B, C, H, W), C in {1, 3}."""
    x = x.float()
    if x.shape[1] == 3:
        gray = (0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2])[:, None]
    else:
        gray = x
    dx = _sobel(gray, False)
    dy = _sobel(gray, True)
    magnitude = torch.sqrt(dx * dx + dy * dy + eps)        # (B, 1, H, W)
    orientation = torch.atan2(dy, dx + eps)
    period = (2 * math.pi) if signed_gradient else math.pi
    bin_width = period / nbins
    if not signed_gradient:
        orientation = torch.abs(orientation)                # map to [0, pi]
    angles = torch.arange(nbins, dtype=torch.float32,
                          device=x.device) * bin_width
    delta = torch.abs(orientation - angles.reshape(1, nbins, 1, 1))
    delta = torch.minimum(delta, period - delta)
    weights = F.relu(1.0 - delta / bin_width)              # (B, nbins, H, W)

    b, _, h, w = x.shape
    nh, nw = (h // cell_size) * cell_size, (w // cell_size) * cell_size
    weighted = (weights * magnitude)[:, :, :nh, :nw]
    hist = weighted.reshape(b, nbins, nh // cell_size, cell_size,
                            nw // cell_size, cell_size).mean(dim=(3, 5))
    hc, wc = hist.shape[2], hist.shape[3]
    if block_size > 1 and hc >= block_size and wc >= block_size:
        blocks = F.unfold(hist, block_size).transpose(1, 2)  # (B, L, C*k*k)
        norm = torch.linalg.vector_norm(blocks, dim=-1, keepdim=True)
        return (blocks / (norm + eps)).reshape(b, -1)
    return hist.reshape(b, -1)


def hog_loss(pred, target, nbins: int = 9, cell_size: int = 8,
             block_size: int = 1, signed_gradient: bool = False,
             loss_type: str = "l2"):
    """HOGLoss (image_restoration_model.py:103-143): descriptor distance.
    Training default is block_size=1 + MSE (:107-109,140-143)."""
    hp = hog_features(pred, nbins, cell_size, block_size, signed_gradient)
    ht = hog_features(target, nbins, cell_size, block_size, signed_gradient)
    if loss_type == "l1":
        return torch.mean(torch.abs(hp - ht))
    return torch.mean(torch.square(hp - ht))


# --- Gaussian pyramid (NeRD-Rain multi-scale supervision) -------------------

_PYR_K1D = tuple(v / 16.0 for v in (1.0, 4.0, 6.0, 4.0, 1.0))


def pyr_down(x):
    """kornia.geometry.transform.pyrdown semantics (used by
    NeRD-Rain-main/train.py:156 build_pyramid): 5x5 binomial blur with
    reflect border, then bilinear halving with align_corners=False — which
    for an exact /2 reduces to 2x2 average pooling."""
    blur = _depthwise(x.float(), _PYR_K1D, "reflect")
    b, c, h, w = blur.shape
    return blur.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def build_pyramid(x, levels: int = 3):
    """[x, pyrdown(x), pyrdown^2(x), ...] — kornia build_pyramid."""
    out = [x.float()]
    for _ in range(levels - 1):
        out.append(pyr_down(out[-1]))
    return out


def gan_loss(logits, target_is_real: bool, use_lsgan: bool = True):
    t = torch.full_like(logits, 1.0 if target_is_real else 0.0)
    if use_lsgan:
        return torch.mean(torch.square(logits - t))
    p = torch.clamp(logits, 1e-7, 1 - 1e-7)
    return -torch.mean(t * torch.log(p) + (1 - t) * torch.log(1 - p))


def pearson_loss(pred, target, eps: float = 1e-8):
    """1 - Pearson correlation over flattened images (HOGformer recipe)."""
    p = pred.reshape(pred.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    p = p - torch.mean(p, dim=1, keepdim=True)
    t = t - torch.mean(t, dim=1, keepdim=True)
    num = torch.sum(p * t, dim=1)
    den = torch.sqrt(torch.sum(p * p, dim=1) * torch.sum(t * t, dim=1)) + eps
    return torch.mean(1.0 - num / den)


def gradient_smoothness_loss(pred, target=None):
    """PINN 'physical constraint': mean |∂y| + mean |∂x| of the prediction
    (PINN_Image_Restoration/model.py:30-36). ``target`` ignored — the prior
    is on the prediction alone (used as mse + this, model.py:66-71)."""
    gy = pred[:, :, 1:, :] - pred[:, :, :-1, :]
    gx = pred[:, :, :, 1:] - pred[:, :, :, :-1]
    return torch.mean(torch.abs(gy)) + torch.mean(torch.abs(gx))


def _normalized(embeddings, eps):
    return embeddings / (torch.linalg.vector_norm(embeddings, dim=-1,
                                                  keepdim=True) + eps)


def contrastive_style_loss(embeddings, labels, pos_margin: float = 0.5,
                           neg_margin: float = 0.0, eps: float = 1e-8):
    """Pairwise contrastive loss over cosine similarity — the MWFormer
    style-filter recipe (MWFormer/main_train_style.py:76-81:
    ContrastiveLoss(pos_margin=0.5, neg_margin=0, distance=CosineSimilarity,
    reducer=MeanReducer)).

    Positive pairs (same weather label) pay relu(pos_margin - sim); negative
    pairs pay relu(sim - neg_margin); each set is averaged, then summed.
    """
    e = _normalized(embeddings, eps)
    sim = e @ e.t()
    same = labels[:, None] == labels[None, :]
    off = ~torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    pos_mask = (same & off).to(sim.dtype)
    neg_mask = (~same).to(sim.dtype)
    pos = F.relu(pos_margin - sim) * pos_mask
    neg = F.relu(sim - neg_margin) * neg_mask
    pos_loss = torch.sum(pos) / torch.clamp(torch.sum(pos_mask), min=1.0)
    neg_loss = torch.sum(neg) / torch.clamp(torch.sum(neg_mask), min=1.0)
    return pos_loss + neg_loss


def supcon_loss(embeddings, labels, temperature: float = 0.1, eps: float = 1e-8):
    """Supervised contrastive loss (vendored SupConLoss,
    MWFormer/pytorch_metric_learning/losses/supcon_loss.py; also the
    CrossRecNet loss_function.py recipe): per anchor,
    -log( sum_pos exp(sim/t) / sum_all exp(sim/t) ), averaged over anchors
    that have at least one positive.
    """
    e = _normalized(embeddings, eps)
    sim = (e @ e.t()) / temperature
    n = labels.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=labels.device)
    same = (labels[:, None] == labels[None, :]) & off
    logz = torch.logsumexp(sim.masked_fill(~off, -math.inf), dim=1)
    pos_cnt = torch.sum(same, dim=1)
    # per anchor: mean over positives of -(sim - logZ)  (SupCon-"out")
    sum_pos = torch.sum(torch.where(same, sim - logz[:, None], 0.0), dim=1)
    per_anchor = -sum_pos / torch.clamp(pos_cnt, min=1)
    valid = pos_cnt > 0
    return torch.sum(torch.where(valid, per_anchor, 0.0)) / torch.clamp(
        torch.sum(valid), min=1)


LOSSES = {
    "l1": l1_loss,
    "l2": mse_loss,
    "mse": mse_loss,
    "smooth_l1": smooth_l1_loss,
    "charbonnier": charbonnier_loss,
    "psnr": psnr_loss,
    "ssim": ssim_loss,
    "fft": fft_loss,
    "fft_abs": fft_abs_loss,
    "focal_l1": focal_l1_loss,
    "edge": edge_loss,
    "pearson": pearson_loss,
    "grad_smooth": gradient_smoothness_loss,
    "hog": hog_loss,
}


def weighted_loss(terms):
    """Compose {name: weight} into one callable(pred, target)."""

    def fn(pred, target):
        total = 0.0
        logs = {}
        for name, w in terms.items():
            v = LOSSES[name](pred, target)
            logs[name] = v
            total = total + w * v
        return total, logs

    return fn
