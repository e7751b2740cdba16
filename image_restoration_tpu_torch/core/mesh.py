"""The mesh over ranks and its axis names (image_restoration_tpu/core/mesh.py).

The JAX package builds one ``jax.sharding.Mesh`` and lets XLA insert the
collectives from sharding constraints. The port runs one process per rank
and builds a ``torch.distributed.device_mesh.DeviceMesh`` with the same
axis names, whose per-axis process groups carry the collectives the port
writes itself:

* ``data``    -- batch-parallel axis: each rank takes its rows of the
                 global batch, and the step reduces the gradients over it
                 (``train/trainer.py``);
* ``expert``  -- the expert-parallel axis of the JAX mesh. JAX's step
                 shards the batch over ``data`` alone and replicates the
                 rest, so ranks that share a data index hold the same rows
                 and compute the same step;
* ``spatial`` -- the halo-exchange axis of whole-image inference
                 (``parallel/halo.py``).

There is no sharding object to carry over: :func:`batch_sharding` and
:func:`replicated` are plain helpers that give a rank its part of a
global array.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class AxisNames:
    data: str = "data"
    expert: str = "expert"
    spatial: str = "spatial"


AXES = AxisNames()


def world_size() -> int:
    """Ranks of the default process group; 1 without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(mesh_shape: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("data", "expert", "spatial"),
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``mesh_shape`` over every rank of the default
    process group, its dimensions named ``axis_names``.

    If ``mesh_shape`` is None, all ranks go on the leading (data) axis and
    the remaining axes get size 1 -- the one-rank and pure data-parallel
    default. A shape whose product is not the number of ranks raises
    ValueError, as the JAX ``make_mesh`` does for the device count.
    ``device_type`` is the ranks' device (default: ``"cuda"`` under NCCL,
    else ``"cpu"``). One process with no process group has no mesh to
    build: a shape of one rank then gives None, which the trainer and the
    CLI take as the one-process step.
    """
    n = world_size()
    if mesh_shape is None:
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if math.prod(mesh_shape) != n:
        raise ValueError(f"mesh_shape {mesh_shape} != #devices {n}")
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh_shape {mesh_shape} names "
                         f"{len(axis_names)} axes {tuple(axis_names)}")
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, mesh_shape,
                            mesh_dim_names=tuple(axis_names))


def data_parallel_mesh(device_type: str | None = None):
    return make_mesh(None, ("data",), device_type)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``; 1 for an axis the mesh lacks or no mesh."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 where :func:`axis_size` is
    1)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def batch_sharding(x, mesh, axis: str = "data"):
    """This rank's rows of a global batch: rows ``index::size`` along
    ``axis``, the rows the loader's strided shard gives it
    (``data/pipeline.py`` ``Loader``). ``x`` is a tensor or a dict of
    them; entries that are not tensors stay as they are."""
    if isinstance(x, dict):
        return {k: batch_sharding(v, mesh, axis) for k, v in x.items()}
    if not isinstance(x, torch.Tensor):
        return x
    return x[axis_index(mesh, axis)::axis_size(mesh, axis)]


def replicated(x, mesh):
    """Every rank holds the whole of ``x``: it is returned as it is."""
    return x


def local_batch_size(global_batch: int, mesh, axis: str = "data") -> int:
    size = axis_size(mesh, axis)
    if global_batch % size:
        raise ValueError(f"batch {global_batch} not divisible by mesh axis "
                         f"{axis}={size}")
    return global_batch // size
