"""The global batch of a data-parallel step.

JAX's multi-device step is the one-device step partitioned by XLA
(image_restoration_tpu/train/trainer.py:207-219): under a sharded jit every
batch reduction -- BatchNorm's statistics, the MoE balance losses' sums,
the loss's mean -- runs over the global batch, and every random draw is the
one the global batch takes. The port runs one process per rank, each with
its rows of the global batch: rows ``index::size`` of the one-process
batch, the loader's strided shard (``data/pipeline.py`` ``Loader``). The
code that reduces over the batch or draws per row asks :func:`current` for
the step's :class:`GlobalBatch`; when there is one it reduces over the
ranks of the mesh's data axis with differentiable collectives, and draws
the global batch's numbers to take its own rows. Outside a data-parallel
step (one process, eval) there is none, and that code runs as before.

A rank's loss is the global loss over ``size``: the sum over the data
ranks is the global loss, and the gradients summed over them are its
gradients. A term computed from globally reduced sums (a balance loss, a
BatchNorm output) has the same value on every rank, and the collectives'
backward sums each rank's share of its gradient, so it is counted once.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch

from image_restoration_tpu_torch.parallel import comm

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("global_batch",
                                                          default=None)


def current():
    """The :class:`GlobalBatch` of the running step, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def using(gb):
    """Makes ``gb`` :func:`current` for the block (None: no global batch)."""
    token = _CURRENT.set(gb)
    try:
        yield gb
    finally:
        _CURRENT.reset(token)


class _Sum(torch.autograd.Function):
    """all-reduce (sum) whose backward is the all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return comm.all_reduce_(t.detach().clone(
            memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce_(g.clone(memory_format=torch.contiguous_format),
                                ctx.group), None


class _Gather(torch.autograd.Function):
    """The global batch from every rank's rows, in the one-process order
    (global row ``i`` is row ``i // size`` of rank ``i % size``); the
    backward sums the global gradient over the ranks and keeps the rank's
    rows."""

    @staticmethod
    def forward(ctx, t, group, index):
        ctx.group, ctx.index = group, index
        parts = comm.all_gather(t.detach(), group)
        ctx.size = len(parts)
        return torch.stack(parts, 1).reshape(t.shape[0] * len(parts),
                                             *t.shape[1:])

    @staticmethod
    def backward(ctx, g):
        g = comm.all_reduce_(g.clone(memory_format=torch.contiguous_format),
                             ctx.group)
        rows = g.shape[0] // ctx.size
        return g.reshape(rows, ctx.size, *g.shape[1:])[:, ctx.index], None, None


@dataclasses.dataclass(frozen=True)
class GlobalBatch:
    """This rank's place in the global batch of a step: the data axis's
    process ``group``, its ``size`` and this rank's ``index`` on it, and
    ``rows``, the rank's rows of the global batch (``size * rows`` in
    all)."""

    group: object
    size: int
    index: int
    rows: int

    def sum(self, t):
        """``t`` summed over the data ranks; differentiable."""
        return _Sum.apply(t, self.group)

    def mean(self, t, n: int):
        """The global mean of per-row terms, from ``t`` = this rank's sum
        over its ``n`` rows (every rank has ``n``)."""
        return self.sum(t) / (n * self.size)

    def gather(self, t):
        """The global batch of a per-row tensor (dim 0 this rank's rows), in
        the one-process order; differentiable."""
        return _Gather.apply(t, self.group, self.index)

    def own(self, t):
        """This rank's rows of a global per-row tensor whose dim 0 holds the
        global batch's rows, each a block of ``t.shape[0] // (size *
        rows)`` entries (tokens of a row, row-major)."""
        per = t.shape[0] // (self.size * self.rows)
        g = t.reshape(self.size * self.rows, per, *t.shape[1:])
        return g[self.index::self.size].reshape(self.rows * per, *t.shape[1:])

    def randn(self, shape, generator, device=None, dtype=torch.float32):
        """This rank's part of the standard normal draw that the global
        batch takes from ``generator``: ``shape`` is the rank's own,
        whose dim 0 holds its ``rows`` rows (each a block of entries)."""
        shape = tuple(shape)
        full = (shape[0] * self.size,) + shape[1:]
        t = torch.randn(full, generator=generator, dtype=dtype,
                        device=device or generator.device)
        return self.own(t)


def batch_sum(t, dim: int = 0):
    """``t.sum(dim)``, over the global batch inside a data-parallel step."""
    s = t.sum(dim=dim)
    gb = current()
    return s if gb is None else gb.sum(s)


def batch_mean(t, dim: int = 0):
    """``t.mean(dim)``, over the global batch inside a data-parallel
    step."""
    gb = current()
    if gb is None:
        return t.mean(dim=dim)
    return gb.mean(t.sum(dim=dim), t.shape[dim])
