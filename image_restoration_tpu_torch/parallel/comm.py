"""The collectives the port writes by hand, over one process group: NCCL's
on CUDA tensors (one rank a device) and gloo's on CPU tensors."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sums ``t`` over ``group`` in place; returns it."""
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype), in group-rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def exchange(sends: Sequence, recvs: Sequence, group) -> None:
    """Point-to-point: each ``(tensor, group_rank)`` of ``sends`` goes to
    that rank, and each ``(tensor, group_rank)`` of ``recvs`` is filled
    from it. All are posted before any is waited on, so a ring of ranks
    that send and receive at once cannot deadlock."""
    ops = [dist.P2POp(dist.isend, t.contiguous(),
                      dist.get_global_rank(group, peer), group)
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, peer),
                       group) for t, peer in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
