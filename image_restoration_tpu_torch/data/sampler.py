"""Samplers and batch-level augmentation, host-side: a copy of
image_restoration_tpu/data/sampler.py (numpy only).

* ``EnlargedSampler`` (HOGformer settingI/basicsr/data/data_sampler.py):
  epoch-seeded permutation over ``len(dataset) * ratio`` virtual indices
  wrapped modulo the dataset, sharded rank::world — the
  dataset-enlarge-ratio trick that avoids dataloader restarts for
  iteration-based training. Ranks are ``torch.distributed`` ranks.
* ``mixup_batch`` (basicsr Mixing_Augment, image_restoration_model.py:
  144-171): Beta(beta, beta)-weighted convex blend of the batch with a
  random permutation of itself, applied to lq and gt with the SAME lambda
  and permutation; optional identity slot.
"""

from __future__ import annotations

import numpy as np


class EnlargedSampler:
    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 ratio: int = 1):
        import math

        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = math.ceil(dataset_len * ratio / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        g = np.random.default_rng(self.epoch)
        indices = g.permutation(self.total_size) % self.dataset_len
        return iter(indices[self.rank : self.total_size : self.num_replicas])

    def __len__(self):
        return self.num_samples


def mixup_batch(lq: np.ndarray, gt: np.ndarray, rng: np.random.Generator,
                beta: float = 1.2, use_identity: bool = False):
    """Batch mixup with one shared lambda/permutation (the reference draws a
    scalar lam and one randperm, :153-161)."""
    n_augs = 1
    pick = rng.integers(0, n_augs + (1 if use_identity else 0))
    if pick >= n_augs:  # identity slot
        return lq, gt
    lam = rng.beta(beta, beta)
    perm = rng.permutation(lq.shape[0])
    lq = lam * lq + (1 - lam) * lq[perm]
    gt = lam * gt + (1 - lam) * gt[perm]
    return lq, gt
