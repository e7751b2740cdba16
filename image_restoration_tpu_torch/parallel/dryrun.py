"""The multi-rank dry run: the three numerical checks of the JAX package's
``dryrun_multichip`` (``__graft_entry__.py:151-332``), over ranks.

1. :func:`check_moce_dp_ep`: a MoCE-IR train step on a (data, expert)
   mesh against the same step in one process -- loss, gradient global
   norm and every updated parameter;
2. :func:`check_restormer_dp`: a data-parallel Restormer step against one
   process (JAX runs it through ``scan_blocks``, which the port does not
   have: here it runs through the port's own blocks);
3. :func:`check_halo`: the halo-exchange Restormer forward on a (data,
   spatial) mesh, temperatures zeroed so the model is conv-local; the
   interior must equal the unsharded forward.

Each check runs inside every rank of an initialised process group and
returns its readings; :func:`dryrun_multichip` spawns ``n`` ranks
(:func:`spawn_ranks`: gloo on the CPU by default) and runs the three. A
check holds its readings to the JAX tolerances in fp32; in bf16 it holds
the sharded run's distance from the one-process bf16 run to three times
the one-process bf16 run's own distance from fp32 (PERF.md section 2's
rule). Weights are drawn from a seed, or come as a state_dict (the tests
pass JAX's, bridged by ``utils/jax_bridge.py``).
"""

from __future__ import annotations

import copy
import multiprocessing.connection
import os
import time
import traceback
import uuid

import numpy as np
import torch

TINY_MOCE = dict(dim=8, levels=3, heads=(2, 4, 8), num_blocks=(1, 1, 1),
                 num_dec_blocks=(1, 1), num_refinement_blocks=1, rank=2,
                 num_experts=4, topk=2, stage_depth=(1, 1))
TINY_RESTORMER_DP = dict(dim=8, num_blocks=(2, 2, 2, 2),
                         num_refinement_blocks=2, heads=(1, 2, 4, 8))
TINY_RESTORMER_HALO = dict(dim=8, num_blocks=(1, 1, 1, 1),
                           num_refinement_blocks=1, heads=(1, 2, 4, 8))
LR = 1e-4


# ---------------------------------------------------------------- ranks --

def _rank_entry(target, rank, n, init_method, workdir, threads, kwargs):
    torch.set_num_threads(threads)
    try:
        result = target(rank, n, init_method, **kwargs)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn_ranks(target, n: int, workdir: str, timeout: float = 240.0,
                threads: int = 1, **kwargs):
    """Runs ``target(rank, n, init_method, **kwargs)`` in ``n`` spawned
    processes and returns their return values, in rank order.

    ``init_method`` is a fresh ``file://`` URL under ``workdir`` (no
    port, so parallel test workers never collide); ``target`` joins the
    group itself (``core/distributed.py``). A rank that fails, or ranks
    still running at ``timeout`` seconds, end the others at once (a rank
    blocked in a collective would otherwise wait for its peer), and this
    raises with the failing rank's traceback. ``target`` must be
    importable (spawned processes import it by name); each rank runs
    torch on ``threads`` threads."""
    os.makedirs(workdir, exist_ok=True)
    init = "file://" + os.path.join(os.path.abspath(workdir),
                                    f"pg-{uuid.uuid4().hex}")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(target, r, n, init, workdir, threads, kwargs))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            left = deadline - time.monotonic()
            if left <= 0:
                failed = "timeout"
                break
            multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.is_alive()], left)
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                failed = bad[0]
                break
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    if failed is None:
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        failed = bad[0] if bad else None
    if failed == "timeout":
        raise TimeoutError(f"{n} ranks still running after {timeout} s; "
                           f"killed")
    if failed is not None:
        err = os.path.join(workdir, f"rank{failed}.err")
        text = open(err).read() if os.path.exists(err) else ""
        raise RuntimeError(f"rank {failed} of {n} failed (exit "
                           f"{procs[failed].exitcode}):\n{text}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def join_group(rank: int, n: int, init_method: str, device: str = "cpu",
               timeout: float = 60.0):
    """Joins the ``n``-rank gloo group, each collective bounded by
    ``timeout`` seconds; a rank on a CUDA ``device`` computes on it (ranks
    may share one card: gloo, unlike NCCL, takes several ranks a card)."""
    from image_restoration_tpu_torch.core.distributed import (
        maybe_initialize_distributed,
    )

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
    maybe_initialize_distributed(init_method, n, rank, device="cpu",
                                 timeout=timeout)


def kernel_launches():
    """Every kernel wrapper's launch count, by the kernel's name."""
    from image_restoration_tpu_torch.kernels import attn_core as KA
    from image_restoration_tpu_torch.kernels import block as KB
    from image_restoration_tpu_torch.kernels import drs_block as KD
    from image_restoration_tpu_torch.kernels import gdfn as KG
    from image_restoration_tpu_torch.kernels import mdta as KQ
    from image_restoration_tpu_torch.kernels import mefc as KM
    from image_restoration_tpu_torch.kernels import ska as KS

    fns = {"block_front": KB.block_front,
           "block_apply_gdfn": KB.block_apply_gdfn,
           "ln_gdfn": KG.fused_ln_gdfn, "ln_qkv_dwconv": KQ.ln_qkv_dwconv,
           "attn_acc": KA.attn_acc, "attn_apply": KA.attn_apply,
           "drs_apply_msfn": KD.drs_apply_msfn, "mefc_step": KM.mefc_step,
           "ska": KS.ska, "ska_bwd_x": KS.ska_bwd_x, "ska_bwd_w": KS.ska_bwd_w}
    return {k: f.launches for k, f in fns.items()}


def _launched(before):
    after = kernel_launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


# --------------------------------------------------------------- models --

def boost_gates(model, factor: float = 100.0):
    """Scales every router's gate weights by ``factor`` (JAX's ``gate_2``
    and ``freq_gate`` kernels, ``__graft_entry__.py:186-195``): at a random
    init the noisy top-k logits are near-tied, so the rounding noise of a
    partitioned step could flip a pick and change the gradients
    discretely; boosted, the logits are O(10) apart and every sharded
    path (routing, dense dispatch, balance losses) still runs."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "gate.2." in name or "freq_gate" in name:
                p.mul_(factor)
    return model


def zero_temperatures(model):
    """Zeroes every MDTA temperature: the channel softmax is then uniform,
    and Restormer is conv-local (``suggest_halo``'s bound is sharp)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("temperature"):
                p.zero_()
    return model


def build(name: str, cfg: dict, device, dtype=None, state_dict=None,
          seed: int = 0, kernels: bool = True):
    """``get_model(name, **cfg)`` drawn from ``seed`` (or loaded from
    ``state_dict``), fp32 parameters computing in ``dtype``, on
    ``device``; with the kernel flags off in fp32 (``dtype`` None: the
    kernels take bf16) or when ``kernels`` is False (the plain model)."""
    from image_restoration_tpu_torch.cli.train import KERNEL_FLAGS
    from image_restoration_tpu_torch.models import get_model

    kw = dict(cfg)
    if dtype is not None:
        kw["dtype"] = dtype
    if dtype is None or not kernels:
        kw.update({f: False for f in KERNEL_FLAGS if kw.get(f)})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = get_model(name, **kw)
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in state_dict.items()})
    return model.to(device)


def _uniform(seed: int, shape):
    return torch.from_numpy(np.random.default_rng(seed).random(
        shape, dtype=np.float32))


# --------------------------------------------------------------- checks --

def _require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _step(model, x, y, noise_seed, mesh, cfg):
    """One train step of ``model`` on (x, y), which on ``mesh`` are this
    rank's rows: (loss, gradient global norm, gradients), the parameters
    updated in place. The JAX check's step: ``value_and_grad``,
    ``global_norm``, the optimizer, ``apply_updates``."""
    from image_restoration_tpu_torch.cli.train import model_apply_kwargs
    from image_restoration_tpu_torch.train.recipes import make_recipe
    from image_restoration_tpu_torch.train.trainer import (
        Optimizer, loss_and_grads, step_global_batch,
    )

    kwargs = model_apply_kwargs(model)
    if getattr(type(model), "uses_moe_rng", False):
        g = torch.Generator(device=x.device)
        g.manual_seed(noise_seed)
        kwargs["generator"] = g
    recipe = make_recipe("default", loss_terms={"l1": 1.0},
                         aux_loss_weight=cfg.aux_loss_weight)
    params = dict(model.named_parameters())
    model.train()
    logs, grads = loss_and_grads(model, recipe, {"lq": x, "gt": y}, kwargs,
                                 params, step_global_batch(mesh, x.shape[0]))
    gnorm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads.values()]))
    tx = Optimizer(cfg)
    updates, _ = tx.update(grads, tx.init(params), params)
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k])
    return (float(logs["total"].detach()), float(gnorm),
            {k: g.detach().float() for k, g in grads.items()})


def _distance(a: dict, b: dict) -> float:
    """Relative L2 distance of two tensor dicts, over all entries."""
    num = sum(float(torch.sum((a[k].float() - b[k].float()) ** 2)) for k in a)
    den = sum(float(torch.sum(b[k].float() ** 2)) for k in a)
    return (num / max(den, 1e-30)) ** 0.5


def _compares() -> bool:
    """Rank 0 runs a check's one-process references and compares; the
    other ranks run only the sharded parts (on a shared card the
    references would run once a rank)."""
    dist = torch.distributed
    return not dist.is_initialized() or dist.get_rank() == 0


def check_train_step(name, model_cfg, mesh, device, x, y, trainer_cfg,
                     dtype=None, state_dict=None, seed=0, prep=None):
    """One train step of registry model ``name`` on ``mesh``, each rank on
    its data rows of (x, y), against the one-process step on the whole
    batch, from the same weights (``prep`` adjusts them) and noise; in
    bf16 also the one-process fp32 step (the 3x rule's yardstick).
    Parameters and the float buffers (BatchNorm's running statistics) are
    held to the one-process ones. Returns the readings: rank 0's hold the
    comparison, the others' the sharded step's alone."""
    from image_restoration_tpu_torch.core.mesh import batch_sharding

    base = build(name, model_cfg, "cpu", None, state_dict, seed)
    if prep is not None:
        prep(base)
    weights = copy.deepcopy(base.state_dict())

    def model_in(dt):
        m = build(name, model_cfg, "cpu", dt, None, seed)
        m.load_state_dict(weights)
        return m.to(device)

    x, y = x.to(device), y.to(device)
    compare = _compares()
    runs = {}
    todo = [("sharded", dtype, batch_sharding(x, mesh),
             batch_sharding(y, mesh), mesh)]
    if compare:
        todo.append(("one", dtype, x, y, None))
        if dtype is not None:
            todo.append(("fp32", None, x, y, None))
    for tag, dt, m_x, m_y, m_mesh in todo:
        m = model_in(dt)
        before = kernel_launches()
        loss, gnorm, grads = _step(m, m_x, m_y, 7, m_mesh, trainer_cfg)
        if tag == "sharded":
            launches = _launched(before)
        params = {k: p.detach().float().cpu()
                  for k, p in m.state_dict().items() if p.is_floating_point()}
        runs[tag] = (loss, gnorm, {k: g.cpu() for k, g in grads.items()},
                     params)
    l_s, g_s, gr_s, p_s = runs["sharded"]
    _require(np.isfinite(l_s), f"{name}: non-finite sharded loss")
    if not compare:
        return {"loss": l_s, "gnorm": g_s, "params": p_s,
                "launches": launches}
    l_1, g_1, gr_1, p_1 = runs["one"]
    out = {"loss": l_s, "loss_one": l_1, "gnorm": g_s, "gnorm_one": g_1,
           "grad_dist": _distance(gr_s, gr_1), "params": p_s,
           "params_one": p_1, "launches": launches}
    if dtype is None:
        np.testing.assert_allclose(l_s, l_1, rtol=1e-4,
                                   err_msg="sharded loss != one-process loss")
        np.testing.assert_allclose(g_s, g_1, rtol=1e-3,
                                   err_msg="sharded grad norm != one-process")
        for k in p_1:
            np.testing.assert_allclose(
                p_s[k].numpy(), p_1[k].numpy(), rtol=1e-3, atol=1e-6,
                err_msg=f"sharded updated {k} diverges from one process")
    else:
        l_f, _, gr_f, _ = runs["fp32"]
        out.update(loss_fp32=l_f, grad_dist_fp32=_distance(gr_1, gr_f))
        _require(abs(l_s - l_1) <= 3 * abs(l_1 - l_f) + 1e-6,
                 f"{name}: sharded loss {l_s} against one process {l_1}, "
                 f"beyond 3x its distance from fp32 {l_f}")
        _require(out["grad_dist"] <= 3 * out["grad_dist_fp32"],
                 f"{name}: gradients {out['grad_dist']} from one process, "
                 f"beyond 3x its {out['grad_dist_fp32']} from fp32")
    return out


def check_moce_dp_ep(mesh, device="cpu", cfg=None, batch=None,
                     size: int = 16, dtype=None, state_dict=None,
                     seed: int = 0):
    """Check 1: MoCE-IR (``cfg``, default :data:`TINY_MOCE`, gates
    boosted) one train step on ``mesh`` -- its data axis splits the
    batch, its expert axis replicates -- against one process. ``batch``
    defaults to 2 rows a data rank; inputs are uniform draws of seeds 1
    and 2 (``batch``, 3, ``size``, ``size``). The optimizer is JAX's
    ``chain(clip_by_global_norm(1.0), adamw(1e-4))``; the loss L1 + 0.01
    x the balance loss."""
    from image_restoration_tpu_torch.core.mesh import axis_size
    from image_restoration_tpu_torch.train.trainer import TrainerConfig

    cfg = TINY_MOCE if cfg is None else cfg
    batch = batch or 2 * axis_size(mesh, "data")
    x = _uniform(1, (batch, 3, size, size))
    y = _uniform(2, (batch, 3, size, size))
    tcfg = TrainerConfig(learning_rate=LR, weight_decay=1e-4, grad_clip=1.0,
                         aux_loss_weight=0.01)
    return check_train_step("moce_ir", cfg, mesh, device, x, y, tcfg, dtype,
                           state_dict, seed,
                           prep=None if state_dict is not None else boost_gates)


def check_restormer_dp(mesh, device="cpu", cfg=None, batch=None,
                       size: int = 16, dtype=None, state_dict=None,
                       seed: int = 1):
    """Check 2: a data-parallel Restormer step (``cfg``, default
    :data:`TINY_RESTORMER_DP`; one row a data rank by default) with
    ``adamw(1e-4)`` on the L1 loss, against one process."""
    from image_restoration_tpu_torch.core.mesh import axis_size
    from image_restoration_tpu_torch.train.trainer import TrainerConfig

    cfg = TINY_RESTORMER_DP if cfg is None else cfg
    batch = batch or axis_size(mesh, "data")
    x = _uniform(3, (batch, 3, size, size))
    y = _uniform(4, (batch, 3, size, size))
    tcfg = TrainerConfig(learning_rate=LR, weight_decay=1e-4)
    return check_train_step("restormer", cfg, mesh, device, x, y, tcfg, dtype,
                           state_dict, seed)


def check_halo(mesh, device="cpu", cfg=None, halo=None, strip: int = 64,
               width: int = 16, dtype=None, state_dict=None, seed: int = 2,
               x=None, bound_halo=None):
    """Check 3: the halo-exchange Restormer forward (``cfg``, default
    :data:`TINY_RESTORMER_HALO`, temperatures zeroed) on a ('data',
    'spatial') mesh: each data rank takes its images, each spatial rank a
    strip of ``strip`` rows, ``halo`` rows from ``suggest_halo(...,
    align=8)`` by default. The interior (``halo`` rows from each end)
    must equal the unsharded forward within 1e-4 in fp32; in bf16, within
    3x the unsharded bf16 forward's own distance from fp32, and
    ``bound_halo`` (a halo under the radius), when given, must miss that
    bound; the unsharded bf16 forward itself (its kernels, on a card) must
    lie within 3x the plain bf16 forward's distance from fp32 over the
    whole image. ``x``: the (B, 3, H, W) image (default uniform, seed 3,
    one image a data rank). Returns the gathered output and the readings."""
    from image_restoration_tpu_torch.core.mesh import axis_size
    from image_restoration_tpu_torch.parallel.halo import (
        gather_strips, halo_tiled_apply, suggest_halo,
    )

    cfg = TINY_RESTORMER_HALO if cfg is None else cfg
    if halo is None:
        halo = suggest_halo(cfg["num_blocks"], cfg["num_refinement_blocks"],
                            align=8)
    if strip < halo:  # a neighbour's strip must hold the rows it sends
        raise ValueError(f"a strip of {strip} rows cannot hold the halo of "
                         f"{halo} a neighbour needs")
    sp, dp = axis_size(mesh, "spatial"), axis_size(mesh, "data")
    if x is None:
        x = _uniform(3, (dp, 3, sp * strip, width))
    base = zero_temperatures(build("restormer", cfg, "cpu", None,
                                   state_dict, seed))
    weights = base.state_dict()

    def model_in(dt, kernels=True):
        m = build("restormer", cfg, "cpu", dt, None, seed, kernels)
        m.load_state_dict(weights)
        return m.to(device).eval()

    x = x.to(device)
    fwd = model_in(dtype)
    batch_axis = "data" if "data" in (mesh.mesh_dim_names or ()) else None

    def sharded(h):
        with torch.inference_mode():
            out = halo_tiled_apply(fwd, x, mesh, h, batch_axis=batch_axis)
            return gather_strips(out, mesh, batch_axis=batch_axis).float()

    before = kernel_launches()
    out = sharded(halo)
    launches = _launched(before)
    small = sharded(bound_halo) if bound_halo is not None else None
    res = {"out": out.cpu(), "halo": halo, "launches": launches,
           "strip_rows": x.shape[2] // sp + 2 * halo}
    if not _compares():
        return res
    with torch.inference_mode():
        full = fwd(x).float()
    inner = slice(halo, x.shape[2] - halo)
    err = float((out[:, :, inner] - full[:, :, inner]).abs().max())
    res.update(full=full.cpu(), interior_err=err)
    if dtype is None:
        _require(err <= 1e-4 + 1e-4 * float(full[:, :, inner].abs().max()),
                 f"halo interior differs from the unsharded forward by {err}")
    else:
        with torch.inference_mode():
            ref = model_in(None)(x).float()
            plain = model_in(dtype, kernels=False)(x).float()
        own = float((full[:, :, inner] - ref[:, :, inner]).abs().max())
        res["bf16_vs_fp32"] = own
        res["full_vs_fp32"] = float((full - ref).abs().max())
        res["plain_vs_fp32"] = float((plain - ref).abs().max())
        _require(res["full_vs_fp32"] <= 3 * res["plain_vs_fp32"],
                 f"the unsharded bf16 forward is {res['full_vs_fp32']} from "
                 f"fp32, beyond 3x the plain bf16 forward's "
                 f"{res['plain_vs_fp32']}")
        _require(err <= 3 * own, f"halo interior error {err} beyond 3x the "
                 f"unsharded bf16 forward's {own} from fp32")
        if small is not None:
            res["small_halo_err"] = float(
                (small[:, :, inner] - full[:, :, inner]).abs().max())
            _require(res["small_halo_err"] > 3 * own,
                     f"halo {bound_halo} under the radius met the bound: "
                     f"{res['small_halo_err']}")
    return res


# -------------------------------------------------------------- dry run --

CHECKS = {"moce": check_moce_dp_ep, "restormer": check_restormer_dp,
          "halo": check_halo}


def checks_rank(rank, n, init_method, checks, device="cpu"):
    """Joins the ``n``-rank gloo group and runs ``checks``, each ``(name,
    mesh_shape, axis_names, kwargs)`` of :data:`CHECKS`, on its mesh;
    returns {name: readings}. On a CUDA ``device`` the ranks share its
    card."""
    from image_restoration_tpu_torch.core.mesh import make_mesh

    join_group(rank, n, init_method, device)
    out = {}
    for name, shape, axes, kwargs in checks:
        mesh = make_mesh(shape, axes)
        out[name] = CHECKS[name](mesh, device, **kwargs)
    return out


def dryrun_multichip(n: int, workdir: str, device: str = "cpu",
                     state_dicts=None, timeout: float = 240.0):
    """The three checks over ``n`` spawned gloo ranks, on JAX's meshes:
    MoCE-IR on (n/ep, ep) data x expert (ep 2 for even n), Restormer on
    (n,) data, the halo forward on (n/sp, sp) data x spatial (sp 4 where
    4 divides n, else 2). ``workdir`` holds the group's rendezvous file
    and the ranks' results; ``state_dicts`` may give each check's weights
    (``moce``, ``restormer``, ``halo``). Returns rank 0's readings; raises
    if any rank's check fails."""
    state_dicts = state_dicts or {}
    ep = 2 if n % 2 == 0 else 1
    sp = 4 if n % 4 == 0 else 2
    checks = [("moce", (n // ep, ep), ("data", "expert"), {}),
              ("restormer", (n,), ("data",), {}),
              ("halo", (n // sp, sp), ("data", "spatial"), {})]
    checks = [(name, shape, axes, {**kw, "state_dict": state_dicts.get(name)})
              for name, shape, axes, kw in checks]
    return spawn_ranks(checks_rank, n, workdir, timeout, checks=checks,
                       device=device)[0]
