"""Classification training engine: the LSNet/DeiT harness
(image_restoration_tpu/train/classification.py).

Reference: 20251113_lsnet_xy/main.py (timm/DeiT engine): label-smoothing or
soft-target cross entropy (:332-340), Mixup/CutMix batch augmentation on
the host (:268-271), model EMA (:310), top-1/top-5 accuracy. The step runs
on the training runtime's ``train/trainer.py`` :class:`Optimizer` and
:class:`TrainState`; with no CLI, as in JAX. On the GPU an LSNet built
with ``use_pallas_ska`` differentiates every SKA through
``kernels/ska.py`` (the forward kernel and the two backward kernels).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from image_restoration_tpu_torch.train.trainer import apply_updates


def cross_entropy(logits, labels, smoothing: float = 0.0):
    """Label-smoothing CE over int labels (B,), or soft-target CE when
    ``labels`` is 2-D (B, classes), the Mixup path; the mean over the
    batch of -sum(target * log_softmax(logits)), in fp32."""
    n = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    if labels.dim() == 1:
        target = F.one_hot(labels.long(), n).float()
        if smoothing:
            target = target * (1 - smoothing) + smoothing / n
    else:
        target = labels.float()
    return -(target * logp).sum(-1).mean()


def accuracy(logits, labels, topk: Tuple[int, ...] = (1, 5)):
    """timm-style top-k accuracies (fractions), as JAX ranks: an ascending
    stable argsort reversed, so of tied logits the higher index ranks
    first."""
    k = max(topk)
    top = torch.argsort(logits, dim=-1, stable=True).flip(-1)[:, :k]
    hits = top == labels[:, None]
    return tuple(float(hits[:, :t].any(dim=1).float().mean()) for t in topk)


def mixup_cutmix(rng: np.random.Generator, images: np.ndarray,
                 labels: np.ndarray, num_classes: int,
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 smoothing: float = 0.1):
    """timm Mixup on the host (NHWC numpy images): returns the images and
    SOFT labels. The JAX function's draws from ``rng`` in its order, so one
    seed gives both packages the same bits."""
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    if smoothing:
        onehot = onehot * (1 - smoothing) + smoothing / num_classes
    if rng.random() >= prob:
        return images, onehot
    perm = rng.permutation(images.shape[0])
    use_cutmix = cutmix_alpha > 0 and rng.random() < switch_prob
    if use_cutmix:
        lam = rng.beta(cutmix_alpha, cutmix_alpha)
        h, w = images.shape[1:3]
        rh, rw = int(h * np.sqrt(1 - lam)), int(w * np.sqrt(1 - lam))
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        y0, y1 = np.clip(cy - rh // 2, 0, h), np.clip(cy + rh // 2, 0, h)
        x0, x1 = np.clip(cx - rw // 2, 0, w), np.clip(cx + rw // 2, 0, w)
        images = images.copy()
        images[:, y0:y1, x0:x1] = images[perm][:, y0:y1, x0:x1]
        lam = 1 - (y1 - y0) * (x1 - x0) / (h * w)
    else:
        lam = rng.beta(mixup_alpha, mixup_alpha) if mixup_alpha > 0 else 1.0
        images = lam * images + (1 - lam) * images[perm]
    soft = lam * onehot + (1 - lam) * onehot[perm]
    return images.astype(np.float32), soft.astype(np.float32)


def make_cls_train_step(model, optimizer, smoothing: float = 0.1,
                        ema_decay: Optional[float] = None):
    """The step ``(state, batch) -> (state, logs)`` for ``batch =
    {"image": NCHW, "label": (B,) int or (B, classes) soft}`` on the
    model's device; ``optimizer`` is ``train/trainer.py``'s
    :class:`Optimizer`, ``state`` its :class:`TrainState`.

    The forward runs as JAX's ``model.apply({"params": params}, image)``
    does, in the model's default mode: the step puts the model in
    ``eval()``, so LSNet's BatchNorms normalise with their running
    statistics and do not update them (JAX passes no ``batch_stats`` to
    update). The EMA, when ``ema_decay`` is given and the state has one,
    is ``decay * ema + (1 - decay) * params`` after the update. ``logs``
    holds the loss, a detached 0-d tensor."""
    params = dict(model.named_parameters())

    def step(state, batch):
        model.eval()
        logits = model(batch["image"])
        loss = cross_entropy(logits, batch["label"], smoothing)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        updates, state.opt_state = optimizer.update(grads, state.opt_state,
                                                    params)
        apply_updates(state, params, updates, ema_decay)
        state.step += 1
        return state, {"loss": loss.detach()}

    return step
