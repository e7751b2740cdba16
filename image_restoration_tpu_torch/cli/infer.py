"""Inference entry point: restore an image or every image in a folder.

Usage:
  python -m image_restoration_tpu_torch.cli.infer --model restormer \
      --ckpt restormer.pth --input photos/ --output_dir restored/

  python -m image_restoration_tpu_torch.cli.infer --model drsformer \
      --ckpt drsformer_rain.pth --input rainy/ --output_dir derained/

  python -m image_restoration_tpu_torch.cli.infer --model adair \
      --ckpt adair.pth --input degraded/ --output_dir restored/

  # the three-kernel Restormer block, on restormer or adair
  python -m image_restoration_tpu_torch.cli.infer --model restormer \
      --set model_kwargs.fused_block=False \
      --set model_kwargs.fused_attn=True --set model_kwargs.fused_gdfn=True \
      --input photos/ --output_dir restored/

Each image is reflect-padded to a multiple of ``--pad_multiple`` (8), run
through the model and cropped back, as the JAX ``cli/infer.py`` does. On a
GPU the default Restormer and AdaIR run every TransformerBlock through the
two CUDA kernels of ``kernels/block.py`` (AdaIR's FreModules are plain
torch); with the three flags above every block runs ``kernels/mdta.py``,
``kernels/attn_core.py`` (two kernels) and ``kernels/gdfn.py`` instead.
DRSformer runs every block through pass 1 of ``kernels/block.py`` and
``kernels/drs_block.py``'s MSFN pass, and its two MEFC Subnets step by step
through ``kernels/mefc.py``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff")


def list_images(path: str):
    if os.path.isfile(path):
        return [path]
    names = sorted(n for n in os.listdir(path)
                   if n.lower().endswith(IMG_EXTS))
    return [os.path.join(path, n) for n in names]


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def save_image(path: str, arr: np.ndarray):
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(arr), 0.0, 1.0)
    Image.fromarray((arr * 255.0).round().astype(np.uint8)).save(path)


def make_restore_fn(cfg, model):
    """Whole-image restorer: (H, W, 3) float32 in [0, 1] -> the same shape,
    clipped to [0, 1]. Runs on the model's device."""
    from image_restoration_tpu_torch.eval.tiled import pad_test

    device = next(model.parameters()).device

    def fwd(x):
        return torch.clamp(model(x), 0.0, 1.0)

    def restore(img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        x = x.permute(2, 0, 1)[None].to(device)
        with torch.inference_mode():
            out = pad_test(fwd, x, cfg.get("pad_multiple", 8))
        return out[0].permute(1, 2, 0).float().cpu().numpy()

    return restore


def build_argparser():
    from image_restoration_tpu_torch.utils.options import build_parser

    p = build_parser()
    p.add_argument("--pad_multiple", type=int, default=8)
    p.add_argument("--output_dir", type=str, default="results")
    p.add_argument("--input", type=str, default=None,
                   help="image file or folder to restore")
    return p


def main(argv=None):
    from image_restoration_tpu_torch.cli.test import load_params
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.utils.options import parse_options

    cfg = parse_options(argv, build_argparser())
    src = cfg.get("input")
    if not src:
        raise SystemExit("--input (image or folder) required")
    paths = list_images(src)
    if not paths:
        raise SystemExit(f"no images found under {src}")
    out_dir = cfg.get("output_dir", "results")
    os.makedirs(out_dir, exist_ok=True)

    model = load_params(cfg, build_model(cfg))
    restore = make_restore_fn(cfg, model)
    print(f"restoring {len(paths)} image(s) -> {out_dir}")
    outs = []
    for i, p in enumerate(paths):
        img = load_image(p)
        res = restore(img)
        dst = os.path.join(out_dir, os.path.basename(p))
        save_image(dst, res)
        outs.append(dst)
        if i % 25 == 0 or i == len(paths) - 1:
            print(f"  [{i + 1}/{len(paths)}] {os.path.basename(p)} "
                  f"{img.shape} -> {res.shape}")
    return outs


if __name__ == "__main__":
    main()
