"""File clients: disk / LMDB / npy-cache backends (a copy of
image_restoration_tpu/data/file_client.py).

References:
* BasicSR ``FileClient`` (HOGformer settingI/basicsr/utils/file_client.py):
  one interface over disk and LMDB (key-value of encoded images) so dataset
  code is storage-agnostic.
* SRConvNet DIV2K loader (SRConvNet-main/datas/div2k.py): decodes each image
  once and memoizes the array as ``.npy`` beside a cache dir, with a
  ``repeat`` factor so iteration-based training re-walks the small dataset.

The LMDB backend is gated on the ``lmdb`` package (absent from this image —
it raises a clear error rather than failing at import time).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class DiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


class LmdbBackend:
    def __init__(self, db_path: str, readonly: bool = True, lock: bool = False,
                 readahead: bool = False):
        try:
            import lmdb
        except ImportError as e:  # pragma: no cover - env without lmdb
            raise ImportError(
                "LMDB backend requires the 'lmdb' package (not installed "
                "in this environment); use backend='disk' or 'npy'") from e
        self.env = lmdb.open(db_path, readonly=readonly, lock=lock,
                             readahead=readahead)

    def get(self, key: str) -> bytes:
        with self.env.begin(write=False) as txn:
            buf = txn.get(key.encode("ascii"))
        if buf is None:
            raise KeyError(key)
        return bytes(buf)


class FileClient:
    """basicsr-compatible facade: client.get(path_or_key)."""

    def __init__(self, backend: str = "disk", **kwargs):
        if backend == "disk":
            self.client = DiskBackend()
        elif backend == "lmdb":
            self.client = LmdbBackend(**kwargs)
        else:
            raise ValueError(f"unknown file client backend {backend!r}")

    def get(self, key: str) -> bytes:
        return self.client.get(key)


def imread_bytes(buf: bytes) -> np.ndarray:
    """Decode encoded image bytes to float32 [0,1] HWC RGB."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(buf)).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


class NpyCachedImage:
    """Decode-once .npy memoization of an image file (div2k.py recipe)."""

    def __init__(self, path: str, cache_dir: Optional[str] = None):
        self.path = path
        base = os.path.splitext(os.path.basename(path))[0] + ".npy"
        root = cache_dir or os.path.join(os.path.dirname(path), "_npy_cache")
        self.cache_path = os.path.join(root, base)

    def load(self) -> np.ndarray:
        if os.path.exists(self.cache_path):
            return np.load(self.cache_path)
        arr = imread_bytes(DiskBackend().get(self.path))
        os.makedirs(os.path.dirname(self.cache_path), exist_ok=True)
        np.save(self.cache_path, arr)
        return arr


class RepeatDataset:
    """Virtually repeat a small dataset (div2k.py repeat=40; the AIO
    oversampling analog for SR benchmarks)."""

    def __init__(self, dataset, repeat: int):
        self.dataset = dataset
        self.repeat = repeat

    def __len__(self):
        return len(self.dataset) * self.repeat

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]
