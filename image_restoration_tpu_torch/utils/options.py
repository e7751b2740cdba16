"""Options of the port's inference surface.

The subset of image_restoration_tpu/utils/options.py that the port's entry
points share: the model and its defaults, the seed, the checkpoint, the
precision and the device, with dotted ``--set a.b=c`` overrides, and the
evaluation and inference options of ``cli/test.py`` and ``cli/infer.py``
(with the JAX defaults). ``cli/robust.py`` adds its own arguments. The
training options come with the training port.
"""

from __future__ import annotations

import argparse
import ast
import copy
from typing import Any, Dict

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
                   help="no-GT eval: restore --lq_dir and report NIQE")
    return p


def _set_dotted(cfg: dict, key: str, value: str):
    node = cfg
    parts = key.split(".")
    for k in parts[:-1]:
        node = node.setdefault(k, {})
    try:
        node[parts[-1]] = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        node[parts[-1]] = value


def parse_options(argv=None, parser=None) -> dict:
    """The config dict of ``argv`` parsed by ``parser`` (default
    :func:`build_parser`): every argument, options left unset from the
    model's :data:`OPTION_DEFAULTS` (``pad_multiple`` 8 otherwise),
    ``model_kwargs`` from :data:`MODEL_DEFAULTS`, then the ``--set``
    overrides."""
    args = (parser or build_parser()).parse_args(argv)
    cfg = {k: v for k, v in vars(args).items() if k != "overrides"}
    model = cfg["model"].lower()
    for k, v in OPTION_DEFAULTS.get(model, {}).items():
        if cfg.get(k) is None:
            cfg[k] = v
    if "pad_multiple" in cfg and cfg["pad_multiple"] is None:
        cfg["pad_multiple"] = 8
    cfg["model_kwargs"] = copy.deepcopy(MODEL_DEFAULTS.get(model, {}))
    for ov in args.overrides:
        k, _, v = ov.partition("=")
        _set_dotted(cfg, k, v)
    return cfg
