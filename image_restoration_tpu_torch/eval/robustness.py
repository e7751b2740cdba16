"""Classification robustness evaluation: the LSNet corruption protocol
(image_restoration_tpu/eval/robustness.py).

* **ImageNet-C**: top-1 per (corruption, severity) over the 15 corruption
  folders and severities 1-5, then each corruption's Corruption Error
  relative to AlexNet and the mean CE.
* **ImageNet-A / -R**: top-1 restricted to their 200-class subsets by a
  mask over the model's 1000 logits (``robust_subsets``), built from the
  sorted training-class wnids (torchvision ImageFolder order).
* **FGSM / PGD** (:func:`fgsm_pgd_attack`, ``evaluate_folder(adv=)``):
  the images are attacked in normalized space before they are scored,
  differentiating the model (on the GPU every SKA through the kernels of
  ``kernels/ska.py``, forward and backward).

The JAX package jits one (params, images) -> hits program; here
:func:`batch_hits` is the per-batch scorer, one forward of the model in
eval mode on its device.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# Corruption display name -> ImageNet-C folder name (robust_utils.py:1-17).
CORRUPTIONS: Dict[str, str] = {
    "Brightness": "brightness",
    "Contrast": "contrast",
    "Defocus Blur": "defocus_blur",
    "Elastic Transform": "elastic_transform",
    "Fog": "fog",
    "Frost": "frost",
    "Gaussian Noise": "gaussian_noise",
    "Glass Blur": "glass_blur",
    "Impulse Noise": "impulse_noise",
    "JPEG Compression": "jpeg_compression",
    "Motion Blur": "motion_blur",
    "Pixelate": "pixelate",
    "Shot Noise": "shot_noise",
    "Snow": "snow",
    "Zoom Blur": "zoom_blur",
}

# AlexNet top-1 error rates on ImageNet-C, the mCE normalizer
# (robust_utils.py:19-38; Hendrycks & Dietterich 2019 protocol constants).
CE_ALEXNET: Dict[str, float] = {
    "Gaussian Noise": 0.886428,
    "Shot Noise": 0.894468,
    "Impulse Noise": 0.922640,
    "Defocus Blur": 0.819880,
    "Glass Blur": 0.826268,
    "Motion Blur": 0.785948,
    "Zoom Blur": 0.798360,
    "Snow": 0.866816,
    "Frost": 0.826572,
    "Fog": 0.819324,
    "Brightness": 0.564592,
    "Contrast": 0.853204,
    "Elastic Transform": 0.646056,
    "Pixelate": 0.717840,
    "JPEG Compression": 0.606500,
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def get_mce_from_accuracy(accuracy_pct: float, alexnet_error: float) -> float:
    """Corruption Error = model error / AlexNet error (robust_utils.py:40-45):
    ``accuracy_pct`` in percent, ``alexnet_error`` a fraction from
    :data:`CE_ALEXNET`; CE as a fraction."""
    return (100.0 - accuracy_pct) / (alexnet_error * 100.0)


def subset_logit_mask(all_wnids: Sequence[str], subset_wnids) -> np.ndarray:
    """Boolean (num_classes,) mask selecting the subset's logits
    (robust.py:72,86)."""
    subset = set(subset_wnids)
    return np.array([w in subset for w in all_wnids], bool)


def masked_topk_hits(logits, labels, mask: Optional[np.ndarray], k: int = 5):
    """(top-1 hits, top-k hits), bool (B,) tensors. With ``mask`` the
    logits are restricted to the subset's columns and ``labels`` index into
    the subset (robust.py:51, ``output[:, mask]``)."""
    if mask is not None:
        cols = torch.from_numpy(np.nonzero(mask)[0]).to(logits.device)
        logits = logits[:, cols]
    k = min(k, logits.shape[-1])
    hits = logits.topk(k, dim=-1).indices == labels[:, None]
    return hits[:, 0], hits.any(dim=1)


def batch_hits(model, images, labels, mask: Optional[np.ndarray] = None):
    """Score one batch: ``images`` (B, H, W, 3) normalised, ``labels``
    (B,), numpy or tensors; one forward of ``model`` on its device.
    Returns (top-1 hits, top-5 hits) as bool (B,) tensors there."""
    device = next(model.parameters()).device
    x = torch.as_tensor(images, dtype=torch.float32).to(device)
    y = torch.as_tensor(labels, dtype=torch.long).to(device)
    with torch.inference_mode():
        logits = model(x.permute(0, 3, 1, 2))
    return masked_topk_hits(logits, y, mask)


def fgsm_pgd_attack(model, images, labels, epsilon: float = 1.0 / 255.0,
                    alpha: Optional[float] = None, max_iters: int = 1,
                    random_init: bool = False,
                    generator: Optional[torch.Generator] = None,
                    init_noise=None, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """FGSM (1 iteration, no random start) / PGD (random start) in
    normalized space, as JAX's ``fgsm_pgd_attack`` (robust.py:23-38).

    ``images``: normalized (B, H, W, 3) tensor on the model's device,
    ``labels`` (B,). The ball and the step are ``epsilon / std`` and
    ``alpha / std`` per channel (``alpha`` defaults to ``epsilon``); each
    iterate takes a step along the sign of the cross entropy's gradient,
    is clipped to the ball around ``images`` and to the normalized image
    of [0, 1]. PGD's random start is ``images + u * eps`` with u uniform in
    [-1, 1): ``init_noise`` when given (the tests hand both packages the
    same u), else drawn from ``generator`` (default: a generator on the
    images' device seeded 0, as JAX's default key is ``PRNGKey(0)``).
    Returns the attacked images, detached. The model runs as it is set
    (eval for scoring); only the images are differentiated.
    """
    dt, dev = images.dtype, images.device
    std = torch.as_tensor(std, dtype=dt, device=dev)
    mean = torch.as_tensor(mean, dtype=dt, device=dev)
    eps = epsilon / std
    step = (alpha if alpha is not None else epsilon) / std
    lower, upper = (0.0 - mean) / std, (1.0 - mean) / std
    labels = torch.as_tensor(labels, dtype=torch.long, device=dev)

    x0 = images.detach()
    x = x0
    if random_init:
        if init_noise is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            init_noise = torch.rand(x0.shape, generator=generator,
                                    device=dev, dtype=dt) * 2 - 1
        x = x0 + torch.as_tensor(init_noise, dtype=dt, device=dev) * eps
    x = torch.clamp(x, lower, upper)
    for _ in range(max_iters):
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            logp = torch.log_softmax(model(x.permute(0, 3, 1, 2)).float(),
                                     dim=-1)
            loss = -logp.gather(1, labels[:, None]).mean()
            (g,) = torch.autograd.grad(loss, x)
        x = x.detach() + step * torch.sign(g)
        x = torch.clamp(x, x0 - eps, x0 + eps)
        x = torch.clamp(x, lower, upper)
    return x.detach()


def _list_imagefolder(root: str) -> Tuple[Sequence[str],
                                          Sequence[Tuple[str, int]]]:
    """(sorted class names, [(path, class index), ...]), torchvision
    ImageFolder order (sorted class dirs, sorted files)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    samples = []
    for idx, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".webp")):
                samples.append((os.path.join(cdir, f), idx))
    return classes, samples


def _load_batch(paths, size: int) -> np.ndarray:
    """(N, size, size, 3) float32, ImageNet-normalised: each image upscaled
    (bicubic) when its short side is below ``size``, then center-cropped."""
    from PIL import Image

    out = np.zeros((len(paths), size, size, 3), np.float32)
    for i, p in enumerate(paths):
        img = Image.open(p).convert("RGB")
        w, h = img.size
        if min(w, h) < size:
            s = size / min(w, h)
            img = img.resize((max(size, int(round(w * s))),
                              max(size, int(round(h * s)))), Image.BICUBIC)
            w, h = img.size
        x0, y0 = (w - size) // 2, (h - size) // 2
        arr = np.asarray(img.crop((x0, y0, x0 + size, y0 + size)), np.float32)
        out[i] = arr / 255.0
    return (out - IMAGENET_MEAN) / IMAGENET_STD


def evaluate_folder(model, root: str, batch_size: int = 64,
                    input_size: int = 224, mask: Optional[np.ndarray] = None,
                    adv: Optional[str] = None):
    """Accuracy over one ImageFolder tree (robust.py:10-63):
    {"acc1": %, "acc5": %, "n": count}; each image's label is its class
    dir's index in the tree. With ``adv`` "FGSM" or "PGD" each batch is
    attacked first, as JAX's ``evaluate_folder`` does: epsilon 1/255;
    FGSM one iteration of step 1/255, PGD five of step 0.5/255 from a
    random start (a generator seeded 0 for every batch, as JAX's default
    key)."""
    if adv not in (None, "FGSM", "PGD"):
        raise ValueError(f"adv={adv!r}: FGSM or PGD")
    _, samples = _list_imagefolder(root)
    device = next(model.parameters()).device
    n = h1 = h5 = 0
    for i in range(0, len(samples), batch_size):
        chunk = samples[i:i + batch_size]
        imgs = _load_batch([p for p, _ in chunk], input_size)
        labels = np.array([l for _, l in chunk])
        if adv is not None:
            imgs = fgsm_pgd_attack(
                model, torch.from_numpy(imgs).to(device), labels,
                epsilon=1.0 / 255.0,
                alpha=0.5 / 255.0 if adv == "PGD" else 1.0 / 255.0,
                max_iters=5 if adv == "PGD" else 1,
                random_init=adv == "PGD")
        t1, t5 = batch_hits(model, imgs, labels, mask)
        h1 += int(t1.sum())
        h5 += int(t5.sum())
        n += len(chunk)
    return {"acc1": 100.0 * h1 / max(n, 1), "acc5": 100.0 * h5 / max(n, 1),
            "n": n}


def imagenet_c_eval(model, inc_path: str, batch_size: int = 64,
                    input_size: int = 224,
                    severities: Sequence[int] = (1, 2, 3, 4, 5),
                    corruptions: Optional[Dict[str, str]] = None,
                    log: Callable[[str], None] = print):
    """The ImageNet-C protocol (robust.py:108-147): accuracy per
    (corruption, severity), per corruption its mean and CE, overall the
    mean accuracy and mCE. Returns {"per_severity", "per_corruption":
    {name: {"acc1", "ce"}}, "acc1", "mce" (a fraction)}."""
    corruptions = corruptions or CORRUPTIONS
    per_sev, per_cor = {}, {}
    mce = overall = 0.0
    for name, folder in corruptions.items():
        acc = 0.0
        for s in severities:
            stats = evaluate_folder(model, os.path.join(inc_path, folder,
                                                        str(s)),
                                    batch_size, input_size)
            per_sev[f"{name}({s})"] = stats["acc1"]
            log(f"Accuracy on the {name}({s}): {stats['acc1']:.1f}%")
            acc += stats["acc1"]
        acc /= len(severities)
        ce = get_mce_from_accuracy(acc, CE_ALEXNET[name])
        per_cor[name] = {"acc1": acc, "ce": ce}
        log(f"{name}: Top1 accuracy {acc:.2f}, CE: {100.0 * ce:.2f}")
        mce += ce
        overall += acc
    k = len(corruptions)
    log(f"Corruption Top1 accuracy {overall / k:.2f}, mCE: {100.0 * mce / k:.2f}")
    return {"per_severity": per_sev, "per_corruption": per_cor,
            "acc1": overall / k, "mce": mce / k}
