"""Options of the port's entry points (image_restoration_tpu/utils/options.py).

:func:`build_parser` holds what the entry points share: the model and its
defaults, the seed, the checkpoint, the precision and the device, with
dotted ``--set a.b=c`` overrides, and the evaluation and inference options
of ``cli/test.py`` and ``cli/infer.py`` (with the JAX defaults).
``cli/robust.py`` adds its own arguments, and :func:`build_train_parser`
the training options of ``cli/train.py`` (JAX ``utils/options.py:84-156``),
with ``--config``: a YAML file whose keys become defaults (explicit flags
win), read when ``pyyaml`` imports and refused otherwise, as in JAX. The
effective config is dumped per experiment (:func:`dump_effective_config`).
"""

from __future__ import annotations

import argparse
import ast
import copy
import os
from typing import Any, Dict

try:
    import yaml
except ImportError:  # pragma: no cover - the GPU host may lack pyyaml
    yaml = None

MODEL_DEFAULTS: Dict[str, Dict[str, Any]] = {
    # Restormer-base (Restormer.py defaults); serving runs every block as
    # the two-kernel pair on the GPU (plain passes on the CPU)
    "restormer": dict(dim=48, num_blocks=[4, 6, 6, 8], heads=[1, 2, 4, 8],
                      num_refinement_blocks=4, ffn_expansion_factor=2.66,
                      fused_block=True),
    # AdaIR (JAX utils/options.py:32-33); serving runs every block as the
    # two-kernel pair, as the JAX package serves it (bench.py)
    "adair": dict(dim=48, num_blocks=[4, 6, 6, 8], heads=[1, 2, 4, 8],
                  num_refinement_blocks=4, fused_block=True),
    # DRSformer (DRSformer_arch.py defaults; JAX utils/options.py:49);
    # serving runs every block as K1 + K7 and every MEFC step as K8
    "drsformer": dict(dim=48, num_blocks=[4, 6, 6, 8], heads=[1, 2, 4, 8],
                      ffn_expansion_factor=2.66, fused_block=True),
    # LSNet-T (JAX utils/options.py:56-57; S and B through --set
    # model_kwargs.*); serving runs every LSConv's SKA as the CUDA kernel
    "lsnet": dict(embed_dim=[64, 128, 192, 256], depth=[1, 2, 3, 4],
                  use_pallas_ska=True),
    # CG-IR, MEASNet and NeRD-Rain large (JAX utils/options.py:52,54,48);
    # serving runs every TransformerBlock as the two-kernel pair
    "cg_ir": dict(dim=48, num_blocks=[4, 6, 6, 8], heads=[1, 2, 4, 8],
                  fused_block=True),
    "measnet": dict(dim=32, fused_block=True),
    "nerd_rain": dict(dim=48, num_blocks=[2, 3, 3], heads=[1, 2, 4],
                      fused_block=True),
    # MoCE-IR big (MoCE-IR-main/src/options.py:69-84; JAX
    # utils/options.py:35-40); serving runs every encoder, latent and
    # refinement block as the two-kernel pair, the decoder in plain torch
    "moce_ir": dict(dim=48, levels=4, num_blocks=[4, 6, 6, 8],
                    num_dec_blocks=[2, 4, 4], heads=[1, 2, 4, 8],
                    num_refinement_blocks=4, topk=1, num_experts=4, rank=2,
                    stage_depth=[1, 1, 1], rank_type="spread",
                    depth_type="constant", with_complexity=True,
                    complexity_scale="max", fused_block=True),
    # IGMoCE-IR (JAX utils/options.py:53), LumiSenseMoE and the
    # patch-routed MoCE-IR (their JAX field defaults): plain torch, as
    # plain XLA in JAX
    "igmoce_ir": dict(dim=48, num_blocks=[4, 6, 6, 8], heads=[1, 2, 4, 8]),
    "lumisense_moe": dict(),
    "moce_ir_patch": dict(),
    # TransWeather's paper configuration (its field defaults), SRConvNet x4
    # and DarkIR-m (JAX utils/options.py:41-46): plain torch, as plain XLA
    # in JAX
    "transweather": dict(),
    "srconvnet": dict(dim=64, n_blocks=10, num_heads=8, scale=4),
    "darkir": dict(width=32, enc_blk_nums=[1, 2, 3], middle_blk_num_enc=2,
                   middle_blk_num_dec=2, dec_blk_nums=[3, 1, 1],
                   dilations=[1, 4, 9]),
    # HOGformer (JAX utils/options.py:51), SFHformer and MWFormer (their
    # field defaults, as in JAX; mwformer_backbone and mwformer_style
    # too): plain torch, as plain XLA in JAX
    "hogformer": dict(dim=36, num_blocks=[4, 4, 6, 8], heads=[1, 2, 4, 8]),
    "sfhformer": dict(),
    "mwformer": dict(),
    # ViG-T and HierViG-T (their field defaults, JAX utils/options.py:
    # 69-70) and the dense engines over LSNet-T (JAX utils/options.py:
    # 59-60: COCO's 80 classes, ADE20K's 150): plain torch, as plain XLA in
    # JAX (the dense engines run SKA plain, as the JAX ones do)
    "vig": dict(),
    "vig_h": dict(),
    "retinanet_lsnet": dict(num_classes=80),
    "semanticfpn_lsnet": dict(num_classes=150),
    # IPT and EDT with AdaptIR's adapters (their field defaults, JAX
    # utils/options.py:67-68: IPT's task 5, EDT's sr_2): plain torch, as
    # plain XLA in JAX. IPT takes 48x48 inputs (serve with --tile 48); EDT
    # takes sides that are multiples of 24 (sr) or 96 (denoise, derain)
    "ipt": dict(),
    "edt": dict(),
    # RectiFormer, FPN-Restormer and MyModel (their field defaults, JAX
    # utils/options.py:64-66): plain torch, as plain XLA in JAX. All three
    # take sides that are multiples of 8 (the default --pad_multiple);
    # RectiFormer gives NaN below 64x64 (its DGSB mask's width is 0 there)
    "rectiformer": dict(),
    "fpn_restormer": dict(),
    "mymodel": dict(),
    # SFSNiD, HiLo and PINN (JAX utils/options.py:72-74): plain torch, as
    # plain XLA in JAX. SFSNiD takes sides that are multiples of 4 (the
    # default --pad_multiple 8 gives them); HiLo maps its input to dim
    # channels, an attention layer the CLIs refuse (model level only)
    "sfsnid": dict(),
    "hilo": dict(dim=96),
    "pinn": dict(),
}

# Per-model defaults of top-level options. NeRD-Rain's quarter-scale
# branch halves twice, so its inputs are padded to multiples of 16.
OPTION_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "nerd_rain": dict(pad_multiple=16),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("image_restoration_tpu_torch")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VAL", help="dotted config override")
    p.add_argument("--model", type=str, default="restormer")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init when no --ckpt is given")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; without a GPU the entry "
                        "points raise unless --device cpu is given)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint: torch .pth/.pt/.ckpt, or a JAX .npz")
    p.add_argument("--prefer_ema", action="store_true")
    # data (JAX utils/options.py:85,94)
    p.add_argument("--data_file_dir", type=str, default="data/")
    p.add_argument("--lq_dir", type=str, default=None)
    # eval (the JAX test.py surface, JAX utils/options.py:159-181)
    p.add_argument("--benchmarks", nargs="+", default=["derain"])
    p.add_argument("--mode", type=int, default=None,
                   help="AdaIR-style switch: 0 denoise, 1 derain, 2 dehaze, "
                        "3 aio3, 4 deblur, 5 synllie, 6 aio5")
    p.add_argument("--sigmas", nargs="+", type=float, default=[15, 25, 50],
                   help="noise levels (JAX utils/options.py:163; read by "
                        "no entry point, as in JAX)")
    p.add_argument("--tile", type=int, default=None,
                   help="window size for tiled inference")
    p.add_argument("--lpips_ckpt", type=str, default=None,
                   help="torch .pth with vgg16+lpips-head weights; enables "
                        "the LPIPS column")
    p.add_argument("--pad_multiple", type=int, default=None,
                   help="pad H and W to a multiple of this (default: 8; "
                        "16 for nerd_rain)")
    p.add_argument("--save_images", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="results")
    p.add_argument("--input", type=str, default=None,
                   help="cli.infer source: image file, folder, frame "
                        "sequence dir, or (with ffmpeg on PATH) video file")
    p.add_argument("--fps", type=int, default=24,
                   help="output frame rate when re-encoding video")
    p.add_argument("--unpaired", action="store_true",
                   help="no-GT eval: restore --lq_dir and report NIQE "
                        "(DarkIR testing_unpaired.py analog)")
    p.add_argument("--niqe_params", type=str, default=None,
                   help="niqe_pris_params.npz path (BasicSR's official "
                        "file, which the repo does not ship; --unpaired "
                        "needs it)")
    return p


def build_train_parser() -> argparse.ArgumentParser:
    """:func:`build_parser` plus the training options, with the JAX
    defaults (JAX ``utils/options.py:84-156``)."""
    p = build_parser()
    p.add_argument("--config", type=str, default=None, help="YAML config file")
    # data (mirrors MoCE/AdaIR option names)
    p.add_argument("--de_type", nargs="+",
                   default=["denoise_15", "denoise_25", "denoise_50", "derain", "dehaze"])
    p.add_argument("--patch_size", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--trainset", type=str, default="aio",
                   choices=["aio", "cdd11", "paired"])
    p.add_argument("--cdd11_split", type=str, default="all")
    p.add_argument("--gt_dir", type=str, default=None)
    # optimization
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--scheduler", type=str, default="linear_warmup_cosine")
    p.add_argument("--warmup_epochs", type=int, default=15)
    p.add_argument("--grad_clip", type=float, default=None)
    p.add_argument("--ema_decay", type=float, default=None)
    p.add_argument("--loss", nargs="+", default=["l1=1.0"],
                   help="terms name=weight, e.g. l1=1.0 fft=0.1")
    p.add_argument("--aux_loss_weight", type=float, default=0.01)
    p.add_argument("--recipe", type=str, default="default",
                   help="loss recipe: default|nerd_rain|darkir|transweather|"
                        "hogformer|mwformer_style")
    # mixup (BasicSR mixing_augs, image_restoration_model.py:145-170)
    p.add_argument("--mixup", action="store_true")
    p.add_argument("--mixup_beta", type=float, default=1.2)
    p.add_argument("--mixup_identity", action="store_true",
                   help="use_identity: sometimes skip the mix")
    # progressive patch/batch schedule (BasicSR train.py:296-326)
    p.add_argument("--prog_iters", nargs="+", type=int, default=None,
                   help="group lengths, e.g. 92000 64000 48000 36000 36000 24000")
    p.add_argument("--prog_gt_sizes", nargs="+", type=int, default=None)
    p.add_argument("--prog_batch_sizes", nargs="+", type=int, default=None)
    p.add_argument("--accumulate_grad_batches", type=int, default=1,
                   help="micro-steps per optimizer step (Lightning "
                        "accumulate_grad_batches, MoCE-IR train.py:128-135)")
    p.add_argument("--freeze", nargs="+", default=None,
                   help="top-level param subtree prefixes to freeze")
    p.add_argument("--style_ckpt", type=str, default=None,
                   help="stage-1 StyleFilter checkpoint (a mwformer_style "
                        "run's .pth or ckpt dir, a reference .pth or a JAX "
                        ".npz), loaded into --model mwformer and frozen")
    p.add_argument("--vgg_ckpt", type=str, default=None,
                   help="torchvision vgg16 .pth for the transweather recipe's "
                        "perceptual term (a random-init VGG without it)")
    # plateau LR (BasicSR ReduceLROnPlateau branch, train.py:285-293)
    p.add_argument("--plateau", action="store_true")
    p.add_argument("--plateau_factor", type=float, default=0.5)
    p.add_argument("--plateau_patience", type=int, default=3)
    p.add_argument("--plateau_window", type=int, default=1000)
    # in-training validation (NeRD-Rain train.py:176-198 best-PSNR cycle)
    p.add_argument("--val_lq_dir", type=str, default=None)
    p.add_argument("--val_gt_dir", type=str, default=None)
    p.add_argument("--val_max_images", type=int, default=0,
                   help="cap validation set size (0 = all)")
    p.add_argument("--mesh", nargs="+", type=int, default=None,
                   help="mesh shape d [e [s]] over ('data', 'expert', "
                        "'spatial'); its size must be the number of ranks "
                        "(under torch.distributed.run)")
    # io
    p.add_argument("--ckpt_dir", type=str, default="train_ckpt")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save_every", type=int, default=1000,
                   help="periodic checkpoint every N steps (0: none)")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--val_every", type=int, default=0)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--tb", action="store_true")
    return p


def parse_loss_terms(terms) -> Dict[str, float]:
    if isinstance(terms, dict):
        return {k: float(v) for k, v in terms.items()}
    out = {}
    for t in terms:
        k, _, v = t.partition("=")
        out[k] = float(v) if v else 1.0
    return out


def dump_effective_config(cfg: dict, path: str):
    """The config as YAML, or its ``repr`` without pyyaml."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if yaml is not None:
            yaml.safe_dump(dict(cfg), f, sort_keys=True)
        else:
            f.write(repr(cfg))


def _set_dotted(cfg: dict, key: str, value: str):
    node = cfg
    parts = key.split(".")
    for k in parts[:-1]:
        node = node.setdefault(k, {})
    try:
        node[parts[-1]] = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        node[parts[-1]] = value


def _read_config(path: str) -> dict:
    if yaml is None:
        raise RuntimeError("pyyaml unavailable; cannot read --config")
    with open(path) as f:
        return yaml.safe_load(f) or {}


def parse_options(argv=None, parser=None) -> dict:
    """The config dict of ``argv`` parsed by ``parser`` (default
    :func:`build_parser`): every argument, a ``--config`` file's keys where
    the flag was left at its default, options left unset from the model's
    :data:`OPTION_DEFAULTS` (``pad_multiple`` 8 otherwise),
    ``model_kwargs`` from :data:`MODEL_DEFAULTS` updated by the file's,
    then the ``--set`` overrides; ``loss`` (training) as a {name: weight}
    dict."""
    parser = parser or build_parser()
    args = parser.parse_args(argv)
    ns = {k: v for k, v in vars(args).items()
          if k not in ("overrides", "config")}
    cfg = _read_config(args.config) if getattr(args, "config", None) else {}
    defaults = vars(parser.parse_args([]))
    for k, v in ns.items():
        if k not in cfg or v != defaults.get(k):  # explicit flags win
            cfg[k] = v
    model = cfg["model"].lower()
    for k, v in OPTION_DEFAULTS.get(model, {}).items():
        if cfg.get(k) is None:
            cfg[k] = v
    if "pad_multiple" in cfg and cfg["pad_multiple"] is None:
        cfg["pad_multiple"] = 8
    mcfg = copy.deepcopy(MODEL_DEFAULTS.get(model, {}))
    mcfg.update(cfg.get("model_kwargs") or {})
    cfg["model_kwargs"] = mcfg
    for ov in args.overrides:
        k, _, v = ov.partition("=")
        _set_dotted(cfg, k, v)
    if "loss" in cfg:
        cfg["loss"] = parse_loss_terms(cfg["loss"])
    return cfg
