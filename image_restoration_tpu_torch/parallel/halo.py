"""Spatial-parallel whole-image inference with halo exchange
(image_restoration_tpu/parallel/halo.py).

The image's H axis is split into strips over the mesh's ``spatial`` axis,
one a rank. Each rank takes ``halo`` rows of overlap from its neighbours
by point-to-point sends over the axis's process group
(:func:`_exchange_halos`; JAX's ``ppermute``), runs the restorer on its
strip and halos, and crops the halo away; :func:`gather_strips` rebuilds
the whole image for the caller.

With halo >= the model's conv receptive-field radius the interior strips
equal the unsharded forward exactly. The first and last strips receive
zero halos, so the whole result equals the unsharded forward applied to
the image zero-extended by ``halo`` rows and cropped back (the reference's
pad_test boundary). Models with global per-image statistics (MDTA channel
attention, SCA/GAP gates, whole-image FFT branches) are never halo-exact:
each strip computes its own statistics; ``halo=0`` reproduces window
tiling exactly (the reference's NeRD-Rain window_partitionx protocol,
layers.py:249-304).

Layouts are the port's NCHW: strips are rows of dim 2.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from image_restoration_tpu_torch.core.mesh import axis_index, axis_size
from image_restoration_tpu_torch.parallel import comm


def _exchange_halos(x_strip, halo: int, group):
    """``halo`` rows from the previous and next strips of ``group``.

    x_strip: (B, C, Hs, W), this rank's strip. Returns (B, C, Hs + 2*halo,
    W) with zero halos at the global top and bottom edges; ``halo=0``
    returns the strip untouched (window tiling).
    """
    if halo == 0:
        return x_strip
    if halo > x_strip.shape[2]:
        raise ValueError(f"halo {halo} exceeds the strip's {x_strip.shape[2]}"
                         f" rows: a neighbour has fewer rows to give")
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    shape = x_strip.shape[:2] + (halo,) + x_strip.shape[3:]
    top = x_strip.new_zeros(shape)
    bottom = x_strip.new_zeros(shape)
    sends, recvs = [], []
    if idx > 0:       # my first rows -> the previous strip's bottom halo
        sends.append((x_strip[:, :, :halo], idx - 1))
        recvs.append((top, idx - 1))
    if idx < n - 1:   # my last rows -> the next strip's top halo
        sends.append((x_strip[:, :, -halo:], idx + 1))
        recvs.append((bottom, idx + 1))
    comm.exchange(sends, recvs, group)
    return torch.cat([top, x_strip, bottom], dim=2)


def spatial_shard(x, mesh, axis: str = "spatial"):
    """This rank's strip of (B, C, H, W) ``x``: H split into ``axis``'s
    size contiguous strips."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[2] % n:
        raise ValueError(f"H={x.shape[2]} is not divisible by mesh axis "
                         f"{axis}={n}")
    h = x.shape[2] // n
    return x[:, :, i * h:(i + 1) * h]


def _batch_block(x, mesh, axis: str):
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} is not divisible by mesh axis "
                         f"{axis}={n}")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def halo_tiled_apply(fn: Callable, x, mesh, halo: int,
                     axis: str = "spatial", scale: int = 1,
                     batch_axis: str | None = None):
    """Run ``fn`` over this rank's strip of ``x`` with halo exchange.

    fn: (B, C, h, W) -> (B, C', h*scale, W*scale), the restorer.
    x: the whole (B, C, H, W) image on every rank, H divisible by the size
    of ``axis``. ``batch_axis``: a mesh axis to also split the batch over
    (data x spatial eval on a ('data', 'spatial') mesh), B divisible by
    its size; a rank takes a contiguous block of rows, as JAX's
    ``P(batch_axis)``. Returns this rank's output strip, halos cropped;
    :func:`gather_strips` assembles the whole output.
    """
    xs = spatial_shard(x, mesh, axis)
    if batch_axis is not None:
        xs = _batch_block(xs, mesh, batch_axis)
    out = fn(_exchange_halos(xs, halo, mesh.get_group(axis)))
    return out[:, :, halo * scale: out.shape[2] - halo * scale]


def gather_strips(out, mesh, axis: str = "spatial",
                  batch_axis: str | None = None):
    """The whole output from every rank's :func:`halo_tiled_apply` strip,
    on every rank."""
    out = torch.cat(comm.all_gather(out, mesh.get_group(axis)), dim=2)
    if batch_axis is not None:
        out = torch.cat(comm.all_gather(out, mesh.get_group(batch_axis)),
                        dim=0)
    return out


def suggest_halo(num_blocks=(4, 6, 6, 8), num_refinement_blocks: int = 4,
                 dwconvs_per_block: int = 2, kernel: int = 3,
                 cap: int | None = None, align: int | None = None) -> int:
    """Conv-path receptive-field RADIUS of a Restormer-geometry U-Net -- the
    halo at which the spatially-local part of the model becomes exact.

    Each TransformerBlock applies ``dwconvs_per_block`` kxk depthwise convs
    at its level's stride 2^l; encoder and decoder both traverse the level,
    the latent level runs at stride 2^(L-1), and refinement at stride 1.
    The pixel-shuffle resamplers' 3x3 convs add one kernel radius per hop.
    Global-statistics ops (channel attention, GAP gates, FFT) are NOT
    covered (module docstring). ``cap`` clamps the suggestion (a halo
    larger than the strip height is wasted work).

    ``align`` rounds the radius UP to a multiple (2^(levels-1) for a
    pixel-shuffle U-Net): the resamplers are shift-invariant only to
    shifts that are multiples of the total downsampling factor, so a halo
    that is not a multiple of it shifts every strip's downsampling grid
    and the interior never matches, however large the halo."""
    r = kernel // 2
    levels = len(num_blocks)
    radius = 0
    for lv, n in enumerate(num_blocks[:-1]):
        radius += 2 * n * dwconvs_per_block * r * (2 ** lv)  # enc + dec
        radius += 2 * r * (2 ** lv)                           # down/up convs
    radius += num_blocks[-1] * dwconvs_per_block * r * (2 ** (levels - 1))
    radius += num_refinement_blocks * dwconvs_per_block * r
    if align and align > 1:
        radius = -(-radius // align) * align
    return min(radius, cap) if cap else radius
