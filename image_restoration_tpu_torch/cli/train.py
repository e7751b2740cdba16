"""Training entry point — the `src/train.py` surface of the reference zoo
(image_restoration_tpu/cli/train.py; MoCE-IR-main/src/train.py:92-148 call
stack, SURVEY.md §3.1), and the model construction the port's entry points
share.

Usage:
  python -m image_restoration_tpu_torch.cli.train --model restormer \
      --data_file_dir data/ --de_type derain --patch_size 128 --batch_size 8

One process on one GPU (``--device cpu`` to run on the CPU), or one process
per GPU under ``torch.distributed.run``, which starts the process group
(``core/distributed.py``; a one-rank run needs ``IR_TPU_MULTIHOST=1``),
e.g.:

  python -m torch.distributed.run --standalone \
      --nproc_per_node 4 -m image_restoration_tpu_torch.cli.train \
      --model moce_ir --mesh 2 2 --batch_size 8 ...

``--mesh d [e [s]]`` is the ("data", "expert", "spatial") mesh
(``core/mesh.py``), whose size must be the number of ranks; without it
the data axis is gcd(batch_size, ranks), as the JAX CLI picks it, and the
other ranks replicate. ``--batch_size`` is the global batch: each rank
loads its rows (rows ``index::d``, the loader's strided shard), draws the
global batch's noise and takes its rows, and the step is the one-process
step on the global batch (``train/trainer.py``). Rank 0 alone writes the
config, ``metrics.jsonl``, the validation PSNR and the checkpoints; every
rank validates, so none waits in a collective meanwhile. Degradations
synthesised on the device, torch checkpoints with auto-resume
(``train/checkpoint.py``), in-training validation with save-best. On the
GPU every kernel flag trains, each kernel API differentiating as its JAX
custom VJP does (the forward launches the kernels, the backward
recomputes the plain composition): Restormer's default ``fused_block``
runs every TransformerBlock's forward through K1/K2 (``kernels/block.py``);
``--set model_kwargs.fused_block=False --set model_kwargs.fused_attn=True
--set model_kwargs.fused_gdfn=True`` the three-kernel block (K4, K5/K6,
K3); DRSformer's default ``fused_block`` every block through K1 + K7 and
every MEFC step through K8. :func:`build_model` turns off a flag the
model cannot run on (fp32, or a head width the kernels do not take) and
says so. The MoCE family (``moce_ir``, ``igmoce_ir``, ``lumisense_moe``,
``moce_ir_patch``) trains with ``train=True``: noisy top-k routing, its
balance loss weighted into the default recipe by ``--aux_loss_weight``,
the noise drawn each step from ``step_generator(seed, step, device, 1)``
(the JAX loop's ``fold_in(fold_in(rng, step), 1)``). What does not train
raises: MEASNet, IPT, EDT, FPN-Restormer and MyModel, which the JAX CLI
cannot train either (it keeps no ``batch_stats``; they train at model
level, ``model(x, train=True)``), and HiLo, an attention layer that no
CLI serves or trains (:data:`LAYER_MODELS`). RectiFormer, which has no
BatchNorm, trains here as in JAX, and so do SFSNiD (``train=False``: the
default recipe's L1 on its full-size output, as the JAX CLI applies it)
and PINN (the reference's loss is ``--loss mse=1.0 grad_smooth=1.0``).
``--recipe darkir`` supervises DarkIR's side head (``side_loss=True``);
``--recipe transweather`` adds the VGG16 perceptual term, from
``--vgg_ckpt`` or a random init; ``--recipe hogformer`` is HOGformer's
L1 + Pearson + HOG loss. MWFormer trains in two stages: ``--model
mwformer_style --recipe mwformer_style`` trains the style filter
contrastively on the batches' degradation labels (``de_id``), then
``--model mwformer --style_ckpt <its checkpoint>`` loads that filter into
``style_filter`` (:func:`load_style_filter`) and freezes it. TransWeather
and MWFormer train with ``train=False`` (no stochastic depth), as through the
JAX CLI. SFHformer trains with ``train=True`` (its BatchNorms on the
batch's statistics, the running ones updated), as the reference trains
it; the JAX CLI cannot train it (its step applies the parameters alone,
and the BatchNorms read ``batch_stats``). LSNet's classification step is
``train/classification.py``, with no CLI, as in JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def default_device(cfg) -> torch.device:
    """``cfg["device"]`` when given, else the GPU. Without a GPU and without
    an explicit device this raises: the port's entry points run on the
    card, and the CPU only when the caller asks for it."""
    if cfg.get("device"):
        return torch.device(cfg["device"])
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --device cpu to run "
                           "on the CPU")
    return torch.device("cuda")


# The models' kernel flags: the pair (K1 + K2; DRSformer's K1 + K7 and
# K8), and the three-kernel block's halves (K4 + K5/K6, K3).
KERNEL_FLAGS = ("fused_block", "fused_attn", "fused_gdfn")


def build_model(cfg, device=None):
    """Registry model from ``cfg["model"]`` and ``cfg["model_kwargs"]``.

    Computes in bf16 unless ``cfg["bf16"]`` is False (parameters stay fp32).
    The random init is drawn from ``cfg["seed"]`` without touching the
    caller's global RNG state. Returned in eval mode on ``device`` (default:
    :func:`default_device`).

    A kernel flag (:data:`KERNEL_FLAGS`) the model cannot run on is turned
    off, with one printed line saying which and why: every flag when the
    model does not compute in bf16 (the kernels take bf16), and a flag
    whose kernels do not take a block's width (what each module that holds
    a flag reports from its ``kernel_misfits()``, by the wrappers' rules).
    The model is then built again with the flag off and runs those blocks
    plain.
    """
    from image_restoration_tpu_torch.models import get_model

    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg.get("model_kwargs", {}).items()}
    if cfg.get("bf16", True):
        kwargs.setdefault("dtype", torch.bfloat16)

    def build():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.get("seed", 0))
            return get_model(cfg["model"], **kwargs)

    on = [f for f in KERNEL_FLAGS if kwargs.get(f)]
    if on and kwargs.get("dtype") != torch.bfloat16:
        why = {f: f"the model computes in {kwargs.get('dtype') or 'float32'}"
                  f" and the kernels take bfloat16" for f in on}
    else:
        model = build()
        why = {}
        for m in model.modules():
            if hasattr(m, "kernel_misfits"):
                for flag, reason in m.kernel_misfits().items():
                    why.setdefault(flag, reason)
    for flag, reason in why.items():
        print(f"build_model: {flag} off: {reason}")
        kwargs[flag] = False
    if why:
        model = build()
    return model.to(device or default_device(cfg)).eval()


def build_dataset(cfg):
    from image_restoration_tpu_torch.data.datasets import (
        CDD11, AIOTrainDataset, PairedFolderDataset,
    )

    kind = cfg.get("trainset", "aio")
    if kind == "aio":
        return AIOTrainDataset(cfg["data_file_dir"], cfg["de_type"],
                               cfg["patch_size"], seed=cfg.get("seed", 0),
                               name_list_dir=cfg.get("name_list_dir"))
    if kind == "cdd11":
        return CDD11(cfg["data_file_dir"], "train", cfg.get("cdd11_split", "all"),
                     cfg["patch_size"], seed=cfg.get("seed", 0))
    if kind == "paired":
        ds = PairedFolderDataset(cfg["lq_dir"], cfg["gt_dir"])
        return _PatchWrapper(ds, cfg["patch_size"], cfg.get("seed", 0))
    raise ValueError(kind)


class _PatchWrapper:
    """Random-crop+augment adapter over a full-image paired dataset."""

    def __init__(self, ds, patch, seed):
        from image_restoration_tpu_torch.data.augment import (
            paired_random_crop, random_augmentation,
        )

        self.ds, self.patch = ds, patch
        self.rng = np.random.default_rng(seed)
        self._crop, self._aug = paired_random_crop, random_augmentation

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        item = self.ds[i]
        lq, gt = self._crop(item["lq"], item["gt"], self.patch, self.rng)
        lq, gt = self._aug(lq, gt, rng=self.rng)
        return dict(item, lq=lq, gt=gt)


def make_lr_schedule(cfg, steps_per_epoch: int):
    from image_restoration_tpu_torch.train import schedulers as S

    total = cfg.get("max_steps") or cfg["epochs"] * steps_per_epoch
    name = cfg.get("scheduler", "linear_warmup_cosine")
    if name == "linear_warmup_cosine":
        return S.linear_warmup_cosine(cfg["lr"], cfg.get("warmup_epochs", 15) * steps_per_epoch,
                                      total, eta_min=1e-6), total
    if name == "cosine":
        return S.cosine_annealing(cfg["lr"], total, eta_min=1e-6), total
    if name == "cosine_restart_cyclic":
        sc = cfg.get("scheduler_kwargs", {})
        return S.cosine_annealing_restart_cyclic(cfg["lr"], **sc), total
    if name == "multistep":
        sc = cfg.get("scheduler_kwargs", {"milestones": [total // 2, total * 3 // 4]})
        return S.multistep(cfg["lr"], **sc), total
    return S.SCHEDULES[name](cfg["lr"]), total


# forward kwargs implied by a recipe (DarkIR's side projection, which the
# EnhanceLoss supervises)
RECIPE_APPLY_KWARGS = {"darkir": {"side_loss": True}}

def model_apply_kwargs(model) -> dict:
    """Train-time forward kwargs from the model's class flags (JAX
    ``cli/train.py`` ``model_apply_kwargs``): the MoE families
    (``uses_moe_rng``: the step then passes its routing noise's
    generator) and SFHformer (``trains_batch_stats``: its BatchNorms
    normalise with the batch's statistics and update the running ones, as
    the reference trains them) train with ``train=True``."""
    cls = type(model)
    if (getattr(cls, "uses_moe_rng", False)
            or getattr(cls, "trains_batch_stats", False)):
        return {"train": True}
    return {}


def build_recipe_kwargs(cfg, device=None):
    """Recipe arguments that need host-loaded data: the transweather
    recipe's VGG16 (relu1_2/2_2/3_3), on ``device``, from ``--vgg_ckpt``'s
    torchvision vgg16 state_dict through ``vgg16_key_map`` (the keys the
    trunk holds; the deeper layers and the classifier are not used), or
    drawn from seed 1 with a warning without it (JAX
    ``cli/train.py:104-131``)."""
    if cfg.get("recipe") != "transweather":
        return {}
    from image_restoration_tpu_torch.eval.perceptual import (
        VGG16Features, vgg16_key_map,
    )

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        vgg = VGG16Features(taps=(3, 8, 15))
    if cfg.get("vgg_ckpt"):
        from image_restoration_tpu_torch.utils.torch_import import (
            load_torch_checkpoint,
        )

        own = vgg.state_dict()
        sd = {}
        for k, v in load_torch_checkpoint(cfg["vgg_ckpt"]).items():
            mapped = vgg16_key_map(k)
            if mapped in own:
                sd[mapped] = v
        vgg.load_state_dict(sd, strict=True)
    else:
        print("WARNING: --recipe transweather without --vgg_ckpt: the "
              "perceptual term uses a random-init VGG (still a valid "
              "feature metric, but not the paper's)")
    return {"vgg": vgg.to(device or default_device(cfg))}


def load_style_filter(cfg, model):
    """``--style_ckpt``: load a stage-1 StyleFilter into
    ``model.style_filter`` (the MWFormer two-stage driver,
    MWFormer/main_train_style.py:1-75, then the filter's frozen use in the
    restoration stage; JAX ``cli/train.py:134-175``). The checkpoint is a
    ``mwformer_style`` run's ``.pth`` (or its ``ckpt`` directory, whose
    newest step is taken), a reference ``.pth`` (through
    ``style_filter_key_map``) or a JAX ``.npz``, loaded strictly by
    ``cli/test.py`` ``load_params``. Returns the model."""
    path = cfg.get("style_ckpt")
    if not path:
        return model
    if not hasattr(model, "style_filter"):
        raise ValueError("--style_ckpt given but the model has no "
                         "'style_filter' subtree (use --model mwformer)")
    from image_restoration_tpu_torch.cli.test import load_params
    from image_restoration_tpu_torch.train.checkpoint import CheckpointManager

    if os.path.isdir(path):
        ckpts = CheckpointManager(path)
        step = ckpts.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        path = ckpts.path(step)
        print(f"style filter: loaded step {step} from {path}")
    load_params({"ckpt": path, "model": "mwformer_style"}, model.style_filter)
    return model


def freeze_prefixes(cfg) -> tuple:
    """``--freeze``'s subtrees, and ``style_filter`` with ``--style_ckpt``
    (the JAX CLI freezes it only when ``--freeze style_filter`` is also
    given)."""
    frozen = tuple(cfg.get("freeze") or ())
    if cfg.get("style_ckpt") and "style_filter" not in frozen:
        frozen += ("style_filter",)
    return frozen


# Registry names that are layers, not image models: no CLI serves, scores
# or trains them (the JAX CLIs cannot either); they run at model level.
LAYER_MODELS = {
    "hilo": "HiLo maps its input to dim channels: it is an attention layer, "
            "not an image model, and the JAX CLIs cannot serve or train it "
            "either; call it at model level, get_model('hilo', dim=96, "
            "in_dim=C)(x) on a (B, C, H, W) map whose sides are multiples "
            "of window_size",
}


def refuse_layers(cfg):
    """Raise for a registry name of :data:`LAYER_MODELS`, naming the
    model-level call."""
    name = str(cfg.get("model", "")).lower()
    if name in LAYER_MODELS:
        raise NotImplementedError(f"{name}: {LAYER_MODELS[name]}")


def _refuse_unported(cfg):
    refuse_layers(cfg)
    if cfg["model"].lower() == "measnet":
        raise NotImplementedError(
            "measnet: the JAX cli/train.py cannot train MEASNet (it keeps "
            "no batch_stats, which FD's BatchNorm updates in training), so "
            "neither does this CLI; the model trains at model level: "
            "model(img, train=True, generator=g)")
    if cfg["model"].lower() in ("ipt", "ipt_adaptir", "edt", "edt_adaptir"):
        raise NotImplementedError(
            f"{cfg['model']}: the JAX cli/train.py cannot train IPT or EDT "
            f"(it keeps no batch_stats, which the AdaptIR adapters' "
            f"BatchNorms read and update, and IPT takes 48x48 inputs "
            f"only), so neither does this CLI; the models train at model "
            f"level: model(x, train=True)")
    if cfg["model"].lower() == "fpn_restormer":
        raise NotImplementedError(
            "fpn_restormer: the JAX cli/train.py cannot train FPN-Restormer "
            "(it keeps no batch_stats, which its encoder blocks' BatchNorms "
            "read and update), so neither does this CLI; the model trains "
            "at model level: model(x, train=True)")
    if cfg["model"].lower() == "mymodel":
        raise NotImplementedError(
            "mymodel: the JAX cli/train.py cannot train MyModel (it keeps "
            "no batch_stats, which its AdaptIR adapters' BatchNorms read "
            "and update), so neither does this CLI; the model trains at "
            "model level: model(img, train=True, generator=g)")


def build_validator(cfg, model, pad_multiple: int = 8):
    """In-training validation closure -> mean PSNR over a paired folder
    (NeRD-Rain train.py:176-189: forward, per-image PSNR, mean)."""
    from image_restoration_tpu_torch.data.datasets import PairedFolderDataset
    from image_restoration_tpu_torch.eval.metrics import psnr
    from image_restoration_tpu_torch.eval.tiled import pad_test
    from image_restoration_tpu_torch.train.trainer import make_eval_step

    if not (cfg.get("val_lq_dir") and cfg.get("val_gt_dir")):
        return None
    ds = PairedFolderDataset(cfg["val_lq_dir"], cfg["val_gt_dir"])
    n = len(ds)
    if cfg.get("val_max_images"):
        n = min(n, cfg["val_max_images"])
    eval_fn = make_eval_step(model, use_ema=bool(cfg.get("ema_decay")))
    device = next(model.parameters()).device

    def image(a):
        return torch.from_numpy(a).permute(2, 0, 1)[None].to(device)

    def validate(state):
        vals = []
        for i in range(n):
            item = ds[i]
            out = pad_test(lambda z: eval_fn(state, z), image(item["lq"]),
                           pad_multiple)
            vals.append(psnr(out.float(), image(item["gt"]))[0])
        return float(torch.stack(vals).mean())

    return validate


def build_mesh(cfg):
    """The training mesh: ``--mesh``'s shape over ("data", "expert",
    "spatial") (its size must be the number of ranks, as JAX's
    ``make_mesh`` asks), else a (gcd(batch_size, ranks), rest) ("data",
    "expert") mesh when there are several ranks; None for one process
    without ``--mesh`` (or with a one-rank mesh and no process group)."""
    import math

    from image_restoration_tpu_torch.core.mesh import make_mesh, world_size

    if cfg.get("mesh"):
        shape = tuple(cfg["mesh"])
        return make_mesh(shape, ("data", "expert", "spatial")[:len(shape)])
    n = world_size()
    if n == 1:
        return None
    d = math.gcd(cfg["batch_size"], n)
    return make_mesh((d, n // d), ("data", "expert"))


def start_ranks(cfg) -> None:
    """Joins the process group the launcher asks for
    (``core/distributed.py``: torchrun's ``env://`` when its WORLD_SIZE is
    above 1; NCCL on CUDA devices, gloo with ``--device cpu``)."""
    from image_restoration_tpu_torch.core.distributed import (
        maybe_initialize_distributed,
    )

    maybe_initialize_distributed(device=cfg.get("device") or "cuda")


def main(argv=None, max_steps_override: int | None = None):
    """Train as ``argv`` says; returns the final ``TrainState``."""
    from image_restoration_tpu_torch.data.degradations import (
        degrade_batch, mixup_device, step_generator,
    )
    from image_restoration_tpu_torch.data.pipeline import (
        Loader, make_train_iterator,
    )
    from image_restoration_tpu_torch.core.mesh import (
        axis_index, axis_size, local_batch_size,
    )
    from image_restoration_tpu_torch.train.checkpoint import CheckpointManager
    from image_restoration_tpu_torch.train.progressive import (
        ProgressiveSchedule, ReduceLROnPlateau,
    )
    from image_restoration_tpu_torch.train.trainer import (
        TrainerConfig, TrainState, make_optimizer, make_train_step,
        set_lr_scale, step_global_batch,
    )
    from image_restoration_tpu_torch.utils.logging import (
        MessageLogger, count_params,
    )
    from image_restoration_tpu_torch.utils.options import (
        build_train_parser, dump_effective_config, parse_options,
    )

    cfg = parse_options(argv, build_train_parser())
    _refuse_unported(cfg)
    start_ranks(cfg)
    mesh = build_mesh(cfg)
    main_rank = mesh is None or torch.distributed.get_rank() == 0
    exp_dir = os.path.join(cfg["ckpt_dir"], cfg["name"])
    os.makedirs(exp_dir, exist_ok=True)
    if main_rank:
        dump_effective_config(cfg, os.path.join(exp_dir, "config.yaml"))

    device = default_device(cfg)
    seed = cfg.get("seed", 0)
    model = load_style_filter(cfg, build_model(cfg, device)).train()
    dataset = build_dataset(cfg)
    d, d_index = axis_size(mesh, "data"), axis_index(mesh, "data")
    loader = Loader(dataset, local_batch_size(cfg["batch_size"], mesh),
                    seed=seed, num_threads=cfg.get("num_workers", 8),
                    rank=d_index, world_size=d)
    steps_per_epoch = max(len(loader), 1)
    lr_sched, total_steps = make_lr_schedule(cfg, steps_per_epoch)
    if max_steps_override:
        total_steps = max_steps_override

    recipe = cfg.get("recipe", "default")
    moe_rng = getattr(type(model), "uses_moe_rng", False)
    apply_kwargs = {**model_apply_kwargs(model),
                    **RECIPE_APPLY_KWARGS.get(recipe, {})}
    tcfg = TrainerConfig(
        learning_rate=lr_sched, weight_decay=cfg.get("weight_decay", 0.0),
        grad_clip=cfg.get("grad_clip"), ema_decay=cfg.get("ema_decay"),
        loss=cfg["loss"], aux_loss_weight=cfg.get("aux_loss_weight", 0.0),
        recipe=recipe, recipe_kwargs=build_recipe_kwargs(cfg, device),
        apply_kwargs=apply_kwargs,
        plateau=bool(cfg.get("plateau")),
        accumulate_grad_batches=cfg.get("accumulate_grad_batches", 1),
        freeze_prefixes=freeze_prefixes(cfg),
    )
    tx = make_optimizer(tcfg)
    if main_rank:
        shape = ("" if mesh is None else
                 f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        print(f"model={cfg['model']} params={count_params(model)/1e6:.2f}M "
              f"total_steps={total_steps} device={device}{shape}")
    if tcfg.freeze_prefixes and main_rank:
        print(f"frozen param subtrees: {list(tcfg.freeze_prefixes)}")
    state = TrainState.create(model, tx, ema_decay=tcfg.ema_decay)

    ckpt = CheckpointManager(os.path.join(exp_dir, "ckpt"),
                             save_every=cfg.get("save_every", 1000))
    start_step = 0
    if cfg.get("resume"):
        restored, step = ckpt.restore(state)
        if restored is not None:
            state, start_step = restored, step
            print(f"resumed from step {step}")

    logger = (MessageLogger(exp_dir, total_steps, use_tb=cfg.get("tb"),
                            use_wandb=cfg.get("wandb")) if main_rank
              else None)
    step_fn = make_train_step(model, tx, tcfg, mesh)

    # progressive patch/batch schedule (HOGformer/Restormer recipe): a
    # host transform in the prefetch thread
    prog = None
    if cfg.get("prog_iters"):
        prog = ProgressiveSchedule(cfg["prog_iters"], cfg["prog_gt_sizes"],
                                   cfg["prog_batch_sizes"],
                                   scale=cfg.get("scale", 1))
        if d > 1:
            # global batch sizes a multiple of the data axis, each rank
            # subsampling its own rows with the shared index draw
            prog = prog.aligned(d)
            prog = ProgressiveSchedule(prog.iters, prog.gt_sizes,
                                       [b // d for b in prog.batch_sizes],
                                       scale=prog.scale)
        if main_rank:
            print(f"progressive schedule: {prog.num_buckets()} shape buckets")
    prog_rng = np.random.default_rng(seed + 7)
    transform = (lambda s, arrays: prog.apply_batch(arrays, s, prog_rng)) if prog else None

    plateau = None
    if cfg.get("plateau"):
        plateau = ReduceLROnPlateau(factor=cfg.get("plateau_factor", 0.5),
                                    patience=cfg.get("plateau_patience", 3),
                                    window=cfg.get("plateau_window", 1000))
    mixup = bool(cfg.get("mixup"))
    validate = build_validator(cfg, model, cfg.get("pad_multiple", 8))
    val_every = cfg.get("val_every", 0)
    best_psnr = -1.0
    log_every = cfg.get("log_every", 100)

    saved = start_step
    it = make_train_iterator(loader, device,
                             start_epoch=start_step // steps_per_epoch,
                             transform=transform, start_step=start_step)
    try:
        for step in range(start_step, total_steps):
            batch = next(it)
            gb = step_global_batch(mesh, batch["gt"].shape[0])
            gen = step_generator(seed, step, device)
            noise = None
            if gb is not None and "sigma" in batch:
                # the global batch's draw, this rank's rows
                noise = gb.randn(batch["gt"].shape, gen, dtype=batch["gt"].dtype)
            batch = degrade_batch(batch, gen, noise)
            lq, gt = batch["lq"], batch["gt"]
            if mixup:
                # one permutation of the global batch: gathered, mixed,
                # this rank's rows taken back
                full = (lq, gt) if gb is None else (gb.gather(lq),
                                                    gb.gather(gt))
                lq, gt = mixup_device(*full, cfg.get("mixup_beta", 1.2),
                                      bool(cfg.get("mixup_identity")),
                                      step_generator(seed, step, device, 2))
                if gb is not None:
                    lq, gt = gb.own(lq), gb.own(gt)
            moe_noise = (step_generator(seed, step, device, 1) if moe_rng
                         else None)
            step_batch = {"lq": lq, "gt": gt}
            if recipe == "mwformer_style":
                step_batch["de_id"] = batch["de_id"]  # the SupCon labels
            state, logs = step_fn(state, step_batch, moe_noise)
            if main_rank and (step % log_every == 0
                              or step == total_steps - 1):
                logger.log(step, logs)
            if plateau is not None:
                new_scale = plateau.push_loss(float(logs["total"]))
                if new_scale is not None:
                    set_lr_scale(state.opt_state, new_scale)
            if val_every and (step + 1) % val_every == 0 and validate is not None:
                # every rank validates (the same images), so that none
                # waits in a collective while rank 0 alone validates
                val_psnr = validate(state)
                if main_rank:
                    logger.log(step, {"psnr": val_psnr}, prefix="val")
                if main_rank and ckpt.maybe_save_best(step + 1, state,
                                                      val_psnr):
                    best_psnr = val_psnr
                    saved = step + 1
                    print(f"step {step + 1}: new best val PSNR {val_psnr:.3f}")
            # a step's state is written once, whichever save asks first
            if saved != step + 1 and ckpt.should_save(step + 1):
                if main_rank:
                    ckpt.save(step + 1, state)
                saved = step + 1
        if saved != total_steps and main_rank:
            ckpt.save(total_steps, state, force=True)
    finally:
        it.close()
        loader.close()
        if logger is not None:
            logger.close()
    if best_psnr >= 0:
        print(f"best val PSNR: {best_psnr:.3f}")
    if main_rank:
        print(f"done: {total_steps} steps; checkpoints in {exp_dir}/ckpt")
    return state


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
