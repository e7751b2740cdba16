"""Rank bodies of the port's multi-rank tests (jax-free: the spawned ranks
import this module by name, and it must not pull JAX into them).

Each ``*_rank(rank, n, init_method, ...)`` runs in one process of
``parallel/dryrun.py`` ``spawn_ranks``, joins the gloo group itself and
returns what the test compares."""

import os

import numpy as np
import torch


def route_rank(rank, n, init_method, logits, k, seed):
    """The MoE router's training pass on this rank's rows of ``logits``
    inside a data-parallel step: the gates, the balance loss and the
    gradient of the rank's share (loss / n) in its logits."""
    import torch.distributed as dist

    from image_restoration_tpu_torch.ops.moe import route
    from image_restoration_tpu_torch.parallel.dryrun import join_group
    from image_restoration_tpu_torch.parallel.global_batch import (
        GlobalBatch, using,
    )

    join_group(rank, n, init_method)
    mine = torch.from_numpy(logits)[rank::n].clone().requires_grad_()
    gb = GlobalBatch(dist.group.WORLD, n, rank, mine.shape[0])
    g = torch.Generator().manual_seed(seed)
    with using(gb):
        gates, _, _, aux = route(mine, k, True, g)
    (aux / n).backward()
    return {"gates": gates.detach(), "aux": aux.detach(),
            "grad": mine.grad}


def train_step_rank(rank, n, init_method, name, cfg, mesh_shape, axes,
                    batch, size, state_dict=None):
    """``parallel/dryrun.py`` ``check_train_step`` of a registry model on
    a ``mesh_shape`` mesh (L1 loss, adamw(1e-4))."""
    from image_restoration_tpu_torch.core.mesh import make_mesh
    from image_restoration_tpu_torch.parallel import dryrun
    from image_restoration_tpu_torch.train.trainer import TrainerConfig

    dryrun.join_group(rank, n, init_method)
    mesh = make_mesh(mesh_shape, axes)
    x = torch.from_numpy(np.random.default_rng(5).random(
        (batch, 3, size, size), dtype=np.float32))
    y = torch.from_numpy(np.random.default_rng(6).random(
        (batch, 3, size, size), dtype=np.float32))
    tcfg = TrainerConfig(learning_rate=dryrun.LR, weight_decay=1e-4,
                         grad_clip=1.0)
    return dryrun.check_train_step(name, cfg, mesh, "cpu", x, y, tcfg,
                                   state_dict=state_dict)


def cli_rank(rank, n, init_method, argv, steps):
    """``cli/train.py`` ``main(argv)`` as rank ``rank`` of ``n`` (the
    ``IR_TPU_*`` launcher variables); the final model's state_dict."""
    os.environ.update(IR_TPU_COORDINATOR=init_method,
                      IR_TPU_NUM_PROCESSES=str(n),
                      IR_TPU_PROCESS_ID=str(rank))
    from image_restoration_tpu_torch.cli import train

    state = train.main(argv, max_steps_override=steps)
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def mesh_rank(rank, n, init_method, shape):
    """``make_mesh``'s default and a shape of the wrong size, on ``n``
    ranks."""
    from image_restoration_tpu_torch.core.mesh import (
        axis_index, axis_size, local_batch_size, make_mesh,
    )
    from image_restoration_tpu_torch.parallel.dryrun import join_group

    join_group(rank, n, init_method)
    default = make_mesh()
    out = {"names": default.mesh_dim_names, "shape": tuple(default.shape),
           "data_index": axis_index(default, "data"),
           "local": local_batch_size(8, default)}
    mesh = make_mesh(shape, ("data", "expert"))
    out["expert_index"] = axis_index(mesh, "expert")
    out["data_size"] = axis_size(mesh, "data")
    try:
        make_mesh((n + 1,), ("data",))
    except ValueError as e:
        out["error"] = str(e)
    return out


def conv_net(kernels, scale=1):
    """``tests/test_halo.py``'s conv stack in NCHW: 5x5 convs (HWIO numpy
    kernels, zero padding 2) each followed by tanh-GELU (``jax.nn.gelu``'s
    default); with ``scale`` the output is repeated ``scale`` times along
    both sides (a nearest-neighbour upsampler)."""
    import torch.nn.functional as F

    ws = [torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
          for k in kernels]

    def net(x):
        for w in ws:
            x = F.gelu(F.conv2d(x, w, padding=2), approximate="tanh")
        if scale > 1:
            x = x.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
        return x

    return net


def halo_rank(rank, n, init_method, kernels, x, halos, scale, mesh_shape,
              axes, batch_axis=None):
    """``parallel/halo.py`` ``halo_tiled_apply`` of :func:`conv_net` on
    ``x`` for each of ``halos``, gathered: {halo: whole output}."""
    from image_restoration_tpu_torch.core.mesh import make_mesh
    from image_restoration_tpu_torch.parallel.dryrun import join_group
    from image_restoration_tpu_torch.parallel.halo import (
        gather_strips, halo_tiled_apply,
    )

    join_group(rank, n, init_method)
    mesh = make_mesh(mesh_shape, axes)
    net = conv_net(kernels, scale)
    xt = torch.from_numpy(x)
    out = {}
    with torch.no_grad():
        for h in halos:
            strip = halo_tiled_apply(net, xt, mesh, h, scale=scale,
                                     batch_axis=batch_axis)
            out[h] = gather_strips(strip, mesh, batch_axis=batch_axis)
    return out


def recipe_rank(rank, n, init_method, recipe, kwargs, x, y, labels):
    """``train/trainer.py`` ``loss_and_grads`` of a seeded linear embedding
    under ``recipe`` on this rank's rows (``rank::n``) of (x, y, labels)
    inside a data-parallel step: the logs and the summed gradients."""
    import torch.distributed as dist

    from image_restoration_tpu_torch.parallel.dryrun import join_group
    from image_restoration_tpu_torch.parallel.global_batch import GlobalBatch
    from image_restoration_tpu_torch.train.recipes import make_recipe
    from image_restoration_tpu_torch.train.trainer import loss_and_grads

    join_group(rank, n, init_method)
    torch.manual_seed(0)
    model = torch.nn.Linear(x.shape[1], y.shape[1])
    rows = slice(rank, None, n)
    batch = {"lq": torch.from_numpy(x[rows]), "gt": torch.from_numpy(y[rows]),
             "de_id": torch.from_numpy(labels[rows])}
    gb = GlobalBatch(dist.group.WORLD, n, rank, batch["lq"].shape[0])
    logs, grads = loss_and_grads(model, make_recipe(recipe, **kwargs), batch,
                                 gb=gb)
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {k: g.detach() for k, g in grads.items()}}
