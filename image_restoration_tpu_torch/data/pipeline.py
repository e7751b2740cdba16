"""Input pipeline: sharded sampling, threaded decode, device prefetch
(image_restoration_tpu/data/pipeline.py).

Replaces the reference's DataLoader(worker procs) + DistributedSampler +
CPU/CUDA prefetcher stack (HOGformer settingI/basicsr/data/{data_sampler.py,
prefetch_dataloader.py}) with:

* deterministic per-rank index sharding (``torch.distributed`` rank strides
  when a process group is initialised, else one process);
* a thread pool for PIL decode + crop (no fork, no pickling);
* a background thread that collates each batch into pinned host memory and
  copies it to the device on a side stream (the CUDAPrefetcher analog), so
  the copy rides ahead of compute and the step never waits on the host;
* on-device degradation synthesis afterwards (``data/degradations.py``).

Batches are dicts of NCHW float tensors (``lq``, ``gt``) and (B,) tensors
(``de_id``, ``sigma``); the datasets' ``name`` stays on the host.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch


def _collate(samples) -> dict:
    out = {}
    for k in samples[0]:
        if k == "name":
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


def _rank_and_world():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Loader:
    """Epoch-based loader with shuffling, per-rank sharding and threaded decode."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_threads: int = 8,
                 rank: Optional[int] = None, world_size: Optional[int] = None):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.pool = ThreadPoolExecutor(max(num_threads, 1))
        r, w = _rank_and_world()
        self.rank = r if rank is None else rank
        self.world = w if world_size is None else world_size

    def __len__(self):
        n = len(self.ds) // self.world
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        order = order[self.rank::self.world]  # per-rank shard
        nb = len(order) // self.bs if self.drop_last else -(-len(order) // self.bs)
        for b in range(nb):
            idxs = order[b * self.bs : (b + 1) * self.bs]
            samples = list(self.pool.map(self.ds.__getitem__, idxs))
            yield _collate(samples)

    def close(self):
        self.pool.shutdown(wait=True)


def to_device(arrays: dict, device) -> dict:
    """NHWC numpy images to NCHW tensors (and the other arrays to tensors)
    on ``device``: pinned host copies, then ``non_blocking`` copies to a
    CUDA device."""
    cuda = torch.device(device).type == "cuda"
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dim() == 4:
            t = t.permute(0, 3, 1, 2).contiguous()
        if cuda:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=cuda)
    return out


class DevicePrefetcher:
    """Background thread that keeps ``depth`` batches in flight on the
    device; an iterator over them. On a CUDA device each batch is copied on
    a side stream, and the consumer's stream waits for that copy before the
    batch is handed out. ``close()`` stops the thread."""

    def __init__(self, iterator, device, depth: int = 2):
        self.it = iterator
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.error: Optional[Exception] = None
        self.stop = threading.Event()
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _put(self, batch):
        arrays = {k: v for k, v in batch.items() if k != "name"}
        if not self.cuda:
            return to_device(arrays, self.device), None
        with torch.cuda.stream(self.stream):
            out = to_device(arrays, self.device)
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def _work(self):
        try:
            for batch in self.it:
                if self.stop.is_set():
                    break
                self.q.put(self._put(batch))
        except Exception as e:  # re-raised in the consumer by __next__
            self.error = e
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            self.q.put(None)  # every later call ends too
            if self.error is not None:
                raise self.error
            raise StopIteration
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self):
        self.stop.set()
        while self.t.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        self.t.join()


def make_train_iterator(loader: Loader, device, epochs: int = 10**9,
                        start_epoch: int = 0, prefetch: int = 2,
                        transform=None, start_step: int = 0):
    """Infinite (or bounded) stream of device-resident batches.

    ``transform(step, arrays) -> arrays`` runs host-side in the prefetch
    thread before the device copy — the hook for the progressive
    patch/batch schedule (train/progressive.py), which must reshape numpy
    batches first. ``step`` counts consumed batches from ``start_step``
    (resume-correct as long as consumption is sequential).
    """

    def gen():
        step = start_step
        for e in range(start_epoch, epochs):
            for batch in loader.epoch(e):
                if transform is not None:
                    batch = transform(step, batch)
                step += 1
                yield batch

    return DevicePrefetcher(gen(), device, prefetch)
