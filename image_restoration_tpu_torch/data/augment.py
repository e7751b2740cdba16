"""8-way flip/rotation augmentation (AdaIR-main/utils/image_utils.py:101-141),
the crops of the benchmark and training sets; a copy of
image_restoration_tpu/data/augment.py.

Host-side numpy on HWC arrays. ``random_augmentation`` draws mode in [1, 7]
(the reference never draws the identity during training)."""

from __future__ import annotations

import numpy as np


def data_augmentation(image: np.ndarray, mode: int) -> np.ndarray:
    if mode == 0:
        out = image
    elif mode == 1:
        out = np.flipud(image)
    elif mode == 2:
        out = np.rot90(image)
    elif mode == 3:
        out = np.flipud(np.rot90(image))
    elif mode == 4:
        out = np.rot90(image, k=2)
    elif mode == 5:
        out = np.flipud(np.rot90(image, k=2))
    elif mode == 6:
        out = np.rot90(image, k=3)
    elif mode == 7:
        out = np.flipud(np.rot90(image, k=3))
    else:
        raise ValueError(f"invalid augmentation mode {mode}")
    return np.ascontiguousarray(out)


def random_augmentation(*arrays, rng: np.random.Generator | None = None):
    rng = rng or np.random.default_rng()
    mode = int(rng.integers(1, 8))
    return [data_augmentation(a, mode) for a in arrays]


def paired_random_crop(img1: np.ndarray, img2: np.ndarray, patch: int,
                       rng: np.random.Generator | None = None):
    """Same-location crop on a pair (dataset_utils.py:331-340)."""
    rng = rng or np.random.default_rng()
    h, w = img1.shape[:2]
    i = int(rng.integers(0, h - patch + 1))
    j = int(rng.integers(0, w - patch + 1))
    return img1[i : i + patch, j : j + patch], img2[i : i + patch, j : j + patch]


def crop_img_to_base(img: np.ndarray, base: int = 16) -> np.ndarray:
    """Center-crop H and W down to multiples of base (image_utils.crop_img)."""
    h, w = img.shape[:2]
    nh, nw = h - h % base, w - w % base
    top, left = (h - nh) // 2, (w - nw) // 2
    return img[top : top + nh, left : left + nw]
