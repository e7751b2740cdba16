"""Inference entry point: restore an image, every image in a folder, or
the frames of a video (image_restoration_tpu/cli/infer.py).

Usage:
  python -m image_restoration_tpu_torch.cli.infer --model restormer \
      --ckpt restormer.pth --input photos/ --output_dir restored/

  python -m image_restoration_tpu_torch.cli.infer --model drsformer \
      --ckpt drsformer_rain.pth --input rainy/ --output_dir derained/

  python -m image_restoration_tpu_torch.cli.infer --model adair \
      --ckpt adair.pth --input degraded/ --output_dir restored/

  # CG-IR, MEASNet or NeRD-Rain (NeRD-Rain pads to multiples of 16)
  python -m image_restoration_tpu_torch.cli.infer --model nerd_rain \
      --ckpt nerd_rain.npz --input rainy/ --output_dir derained/

  # the MoCE family: moce_ir (a reference .pth or a JAX .npz), igmoce_ir,
  # lumisense_moe, moce_ir_patch
  python -m image_restoration_tpu_torch.cli.infer --model moce_ir \
      --ckpt moce_ir.pth --input degraded/ --output_dir restored/

  # the three-kernel Restormer block, on restormer or adair
  python -m image_restoration_tpu_torch.cli.infer --model restormer \
      --set model_kwargs.fused_block=False \
      --set model_kwargs.fused_attn=True --set model_kwargs.fused_gdfn=True \
      --input photos/ --output_dir restored/

  # tiled: every 128x128 window of an image through the model as one batch
  python -m image_restoration_tpu_torch.cli.infer --model restormer \
      --ckpt restormer.pth --lq_dir rainy/ --tile 128 --output_dir out/

Each image is reflect-padded to a multiple of ``--pad_multiple`` (8; 16
for NeRD-Rain, ``utils/options.py`` ``OPTION_DEFAULTS``), run
through the model and cropped back, or with ``--tile`` cut into windows,
as the JAX ``cli/infer.py`` does. ``--lq_dir`` stands in for ``--input``;
a video file (``.mp4``, ...) is decoded and re-encoded by an ``ffmpeg`` on
PATH, and refused without one. On a GPU the default Restormer and AdaIR
run every TransformerBlock through the two CUDA kernels of
``kernels/block.py`` (AdaIR's FreModules are plain torch); with the three
flags above every block runs ``kernels/mdta.py``,
``kernels/attn_core.py`` (two kernels) and ``kernels/gdfn.py`` instead.
DRSformer runs every block through pass 1 of ``kernels/block.py`` and
``kernels/drs_block.py``'s MSFN pass, and its two MEFC Subnets step by step
through ``kernels/mefc.py``. CG-IR, MEASNet and NeRD-Rain run every block
through the pair of ``kernels/block.py`` (CG-IR's with its per-sample
temperature and output gate in the finalize), the rest in plain torch;
NeRD-Rain's first output, the full-scale restoration, is the image.
MoCE-IR runs its encoder, latent and refinement blocks through the pair
and its complexity-expert decoder in plain torch; IGMoCE-IR, LumiSenseMoE
and the patch-routed MoCE-IR run in plain torch, as the JAX package runs
them without a kernel, as do SRConvNet (``--model srconvnet``, x4 by
default: the output is 4x the input's size), TransWeather and DarkIR,
and the later families (``--model hogformer``, ..., ``--model sfsnid``,
``--model pinn``); HiLo is an attention layer and is refused.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from image_restoration_tpu_torch.utils.precision import full_fp32

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff")
VID_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


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
    """Whole-image restorer: (H, W, 3) float32 in [0, 1] -> the restored
    image, clipped to [0, 1]: window-tiled (``cfg["tile"]``, the NeRD-Rain
    window_partitionx protocol: every window of the image through the model
    as one batch) or pad-to-multiple (``cfg["pad_multiple"]``, default 8).
    A tuple output is unwrapped to its first element. SRConvNet's output
    is ``model_kwargs.scale`` x larger, and the crop keeps that size. Runs
    on the model's device, with TF32 off (:func:`full_fp32`) whatever the
    model's dtype."""
    from image_restoration_tpu_torch.eval.tiled import pad_test, windowed_apply

    device = next(model.parameters()).device
    scale = int(cfg.get("model_kwargs", {}).get("scale", 1)
                if cfg.get("model") == "srconvnet" else 1)

    def fwd(x):
        out = model(x)
        if isinstance(out, tuple):
            out = out[0]
        return torch.clamp(out, 0.0, 1.0)

    def restore(img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        x = x.permute(2, 0, 1)[None].to(device)
        with torch.inference_mode(), full_fp32():
            if cfg.get("tile"):
                out = windowed_apply(fwd, x, cfg["tile"])
            else:
                out = pad_test(fwd, x, cfg.get("pad_multiple", 8),
                               scale=scale)
        return out[0].permute(1, 2, 0).float().cpu().numpy()

    return restore


def _ffmpeg():
    return shutil.which("ffmpeg")


def main(argv=None):
    from image_restoration_tpu_torch.cli.test import load_params
    from image_restoration_tpu_torch.cli.train import (
        build_model, refuse_layers,
    )
    from image_restoration_tpu_torch.utils.options import parse_options

    cfg = parse_options(argv)
    refuse_layers(cfg)
    src = cfg.get("input") or cfg.get("lq_dir")
    if not src:
        raise SystemExit("--input (image, folder, frame dir, or video) "
                         "required")
    is_video = os.path.isfile(src) and src.lower().endswith(VID_EXTS)
    if is_video and not _ffmpeg():
        raise SystemExit(
            "video input needs an ffmpeg binary on PATH (none found) — "
            "extract frames to a folder and pass that instead")
    out_dir = cfg.get("output_dir", "results")
    os.makedirs(out_dir, exist_ok=True)

    model = load_params(cfg, build_model(cfg))
    restore = make_restore_fn(cfg, model)

    tmp = None
    if is_video:
        tmp = tempfile.mkdtemp(prefix="ir_frames_")
        subprocess.run([_ffmpeg(), "-i", src, "-qscale:v", "2",
                        os.path.join(tmp, "f%06d.png")], check=True)
        frames_dir = tmp
    else:
        frames_dir = src
    try:
        paths = list_images(frames_dir)
        if not paths:
            raise SystemExit(f"no images found under {frames_dir}")
        print(f"restoring {len(paths)} frame(s) -> {out_dir}")
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
        if is_video:
            dst = os.path.join(
                out_dir,
                os.path.splitext(os.path.basename(src))[0] + "_restored.mp4")
            subprocess.run([_ffmpeg(), "-y", "-framerate",
                            str(cfg.get("fps", 24)),
                            "-i", os.path.join(out_dir, "f%06d.png"),
                            "-c:v", "libx264", "-pix_fmt", "yuv420p", dst],
                           check=True)
            print(f"encoded {dst}")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return outs


if __name__ == "__main__":
    main()
