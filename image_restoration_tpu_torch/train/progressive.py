"""Progressive patch/batch training schedule and plateau LR: a copy of
image_restoration_tpu/train/progressive.py (numpy only).

Reference: the BasicSR/Restormer recipe (HOGformer-main/settingI/basicsr/
train.py:296-326): training iterations are split into groups; each group uses
a smaller (batch, patch) pair early and grows toward the full size — e.g.
``iters=[92000,64000,48000,36000,36000,24000]``,
``gt_sizes=[128,160,192,256,320,384]``, ``batches=[8,5,4,2,1,1]``.
Subsampling and cropping happen on host numpy (NHWC batches) before the
device copy, like the reference's random.sample / random crop.

Also here: ``ReduceLROnPlateau`` — the BasicSR branch that steps the LR from
a 1000-iteration loss window (train.py:285-293) — as a host-side object whose
factor scales the trainer's updates (``train/trainer.py`` ``set_lr_scale``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class ProgressiveSchedule:
    """Maps a global step to its (mini_batch, mini_gt_size) bucket."""

    iters: Sequence[int]            # group lengths, cumulative boundaries
    gt_sizes: Sequence[int]
    batch_sizes: Sequence[int]
    scale: int = 1                  # SR scale multiplying the gt crop

    def __post_init__(self):
        assert len(self.iters) == len(self.gt_sizes) == len(self.batch_sizes)
        self._bounds = np.cumsum(np.asarray(self.iters))

    def bucket(self, step: int) -> int:
        j = int(np.searchsorted(self._bounds, step, side="right"))
        return min(j, len(self._bounds) - 1)

    def shapes(self, step: int) -> tuple[int, int]:
        j = self.bucket(step)
        return self.batch_sizes[j], self.gt_sizes[j]

    def num_buckets(self) -> int:
        """The distinct (batch, patch) shapes this schedule induces."""
        return len(set(zip(self.batch_sizes, self.gt_sizes)))

    def aligned(self, multiple: int) -> "ProgressiveSchedule":
        """Copy with batch sizes rounded UP to a multiple of the number of
        data-parallel ranks, so every bucket's batch shards evenly."""
        bs = [max(multiple, -(-b // multiple) * multiple) for b in self.batch_sizes]
        return ProgressiveSchedule(list(self.iters), list(self.gt_sizes), bs,
                                   scale=self.scale)

    def apply(self, lq: np.ndarray, gt: np.ndarray, step: int,
              rng: np.random.Generator):
        """Subsample the batch and random-crop the patch for this step's
        bucket (train.py:310-326). lq/gt are NHWC host arrays; gt may be
        ``scale``x larger spatially."""
        bs, gsize = self.shapes(step)
        b, h, w, _ = lq.shape
        if bs < b:
            idx = rng.choice(b, size=bs, replace=False)
            lq, gt = lq[idx], gt[idx]
        if gsize < h or gsize < w:
            x0 = int((h - gsize) * rng.random())
            y0 = int((w - gsize) * rng.random())
            s = self.scale
            lq = lq[:, x0 : x0 + gsize, y0 : y0 + gsize]
            gt = gt[:, x0 * s : (x0 + gsize) * s, y0 * s : (y0 + gsize) * s]
        return lq, gt

    def apply_batch(self, arrays: dict, step: int, rng: np.random.Generator):
        """Dict variant for the pipeline transform hook: subsamples EVERY
        per-sample array (lq, gt, sigma, de_id, ...) with one shared index
        set, then crops lq/gt spatially."""
        bs, gsize = self.shapes(step)
        b, h, w = arrays["lq"].shape[:3]
        out = dict(arrays)
        if bs < b:
            idx = rng.choice(b, size=bs, replace=False)
            out = {k: (v[idx] if isinstance(v, np.ndarray) and v.shape[:1] == (b,)
                       else v) for k, v in out.items()}
        if gsize < h or gsize < w:
            x0 = int((h - gsize) * rng.random())
            y0 = int((w - gsize) * rng.random())
            s = self.scale
            out["lq"] = out["lq"][:, x0 : x0 + gsize, y0 : y0 + gsize]
            out["gt"] = out["gt"][:, x0 * s : (x0 + gsize) * s,
                                  y0 * s : (y0 + gsize) * s]
        return out


class ReduceLROnPlateau:
    """Host-side plateau LR controller (torch semantics, BasicSR usage:
    update every 1000-iter mean-loss window, train.py:285-293)."""

    def __init__(self, factor: float = 0.5, patience: int = 3,
                 threshold: float = 1e-4, min_lr: float = 0.0,
                 mode: str = "min", window: int = 1000):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.mode = mode
        self.window = window
        self.scale = 1.0
        self.best = None
        self.num_bad = 0
        self._buf: list[float] = []

    def _is_better(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best * (1 - self.threshold)
        return value > self.best * (1 + self.threshold)

    def step(self, value: float) -> float:
        """Feed one window-mean metric; returns the current LR scale."""
        if self._is_better(value):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_lr)
                self.num_bad = 0
        return self.scale

    def push_loss(self, loss: float) -> float | None:
        """Accumulate per-iter losses; steps once per full window and
        returns the new scale (else None)."""
        self._buf.append(float(loss))
        if len(self._buf) >= self.window:
            mean = float(np.mean(self._buf))
            self._buf.clear()
            return self.step(mean)
        return None
