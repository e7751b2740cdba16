"""Benchmark eval loops — the `run_{derain,dehaze,denoise_N,...}` registry
(MoCE-IR-main/src/test.py:82-188 string-dispatch) rebuilt around one engine
(image_restoration_tpu/eval/benchmarks.py; here on NCHW tensors).

Each benchmark = dataset factory + metric-protocol kwargs (BenchSpec). The
engine pads each image to a multiple (optionally a coarser ``bucket``
multiple for mixed-size sets like GoPro/LOL) or tiles it, runs the model,
computes PSNR/SSIM (+ optional LPIPS) on the model's device in fp32, and
optionally saves outputs (save_img analog). Protocols covered: AIO 5-task
(MoCE/AdaIR), CDD-11 subset dispatch (MoCE-IR-main/src/test.py:180-184), SR
Y-channel with crop_border=scale (SRConvNet-main/train.py:202-213),
TransWeather RainDrop/Snow100K (test_snow100k.py:42-70)."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict

import numpy as np
import torch

from image_restoration_tpu_torch.data.datasets import (
    CDD11, DenoiseBenchmark, PairedFolderDataset, SRBenchmark,
)
from image_restoration_tpu_torch.eval import metrics as M
from image_restoration_tpu_torch.eval.tiled import pad_test, windowed_apply


@dataclasses.dataclass
class BenchResult:
    name: str
    psnr: float
    ssim: float
    n: int
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BenchSpec:
    """Dataset factory + the metric protocol this benchmark is scored with."""

    factory: Callable
    eval_kw: dict = dataclasses.field(default_factory=dict)


def save_png(path: str, img01: np.ndarray):
    """HWC [0, 1] -> 8-bit PNG, rounding half up (``*255 + 0.5``, then
    truncation), as the JAX ``save_png``."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def _to_device(hwc: np.ndarray, device):
    """HWC numpy -> a (1, C, H, W) tensor on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(hwc))
    return x.permute(2, 0, 1)[None].to(device)


def evaluate(
    fn: Callable,
    dataset,
    name: str = "bench",
    pad_multiple: int = 8,
    tile: int | None = None,
    y_channel: bool = False,
    crop_border: int = 0,
    save_dir: str | None = None,
    scale: int = 1,
    lpips_fn: Callable | None = None,
    bucket: int | None = None,
    device=None,
) -> BenchResult:
    """fn: (B,C,H,W)->(B,C,H*scale,W*scale) restorer on ``device`` (default:
    the GPU). Batch=1 per image (the reference protocol). Shapes are padded
    to x pad_multiple, or to the coarser x ``bucket`` when given.

    ``scale`` > 1 = SR protocol (out is scale-x larger; GT pre-cropped by the
    dataset to lr*scale). ``lpips_fn(out, gt) -> (B,)`` adds a perceptual
    column (MoCE-IR-main/src/test.py:88,105,123 prints PSNR/SSIM/LPIPS)."""
    # the per-image values stay on the device and come back in ONE copy at
    # the end, so the host never waits for the card inside the loop
    device = torch.device("cuda" if device is None else device)
    multiple = bucket if bucket else pad_multiple
    if bucket and bucket % pad_multiple:
        raise ValueError(f"bucket {bucket} must be a multiple of {pad_multiple}")
    psnrs, ssims, lpips_vals, outs = [], [], [], []
    for i in range(len(dataset)):
        item = dataset[i]
        lq = _to_device(item["lq"], device)
        gt = _to_device(item["gt"], device)
        if tile:
            out = windowed_apply(fn, lq, tile)
        else:
            out = pad_test(fn, lq, multiple, scale=scale)
        out = torch.clamp(out, 0.0, 1.0)
        if y_channel:
            psnrs.append(M.psnr_yc(out, gt, crop_border)[0])
            ssims.append(M.ssim_yc(out, gt, crop_border)[0])
        else:
            psnrs.append(M.psnr(out, gt)[0])
            ssims.append(M.ssim(out, gt)[0])
        if lpips_fn is not None:
            lpips_vals.append(lpips_fn(out, gt)[0].float())
        if save_dir:
            outs.append((item["name"], out[0]))
    vals = torch.stack(psnrs + ssims + lpips_vals).cpu().numpy()  # one copy
    n = len(psnrs)
    psnr_v, ssim_v = vals[:n], vals[n : 2 * n]
    extra = {}
    if lpips_vals:
        extra["lpips"] = float(np.mean(vals[2 * n :]))
    for nm, img in outs:
        base = os.path.splitext(os.path.basename(nm))[0]
        save_png(os.path.join(save_dir, name, base + ".png"),
                 img.permute(1, 2, 0).float().cpu().numpy())
    return BenchResult(name, float(np.mean(psnr_v)), float(np.mean(ssim_v)), n,
                       extra=extra)


# ---------------------------------------------------------------------------
# benchmark registry: name -> BenchSpec(dataset factory(data_root), protocol)

def _bsd68(root, sigma):
    return DenoiseBenchmark(os.path.join(root, "denoising/bsd68"), sigma=sigma)


def _paired(a, b, **kw):
    return lambda root: PairedFolderDataset(
        os.path.join(root, a), os.path.join(root, b), **kw)


def _sr(setname, scale):
    # Y-channel + crop_border=scale protocol (SRConvNet train.py:202-213,
    # utils.py:16-63); conv SR nets need no pad multiple
    return BenchSpec(lambda root: SRBenchmark(os.path.join(root, "sr", setname),
                                              scale=scale),
                     dict(y_channel=True, crop_border=scale, scale=scale,
                          pad_multiple=1))


def _cdd11(subset):
    # MoCE-IR-main/src/test.py:180-184: CDD-11 eval dispatch by subset
    # ('all'/'single'/'double'/'triple' or a folder name like 'low_haze')
    return BenchSpec(lambda root: CDD11(root, "test", subset))


BENCHMARKS: Dict[str, BenchSpec] = {
    # 5-task AIO (MoCE-IR-main/src/test.py:127-161 run_* loops)
    "denoise_15": BenchSpec(lambda root: _bsd68(root, 15)),
    "denoise_25": BenchSpec(lambda root: _bsd68(root, 25)),
    "denoise_50": BenchSpec(lambda root: _bsd68(root, 50)),
    "derain": BenchSpec(_paired("deraining/Rain100L/input",
                                "deraining/Rain100L/target")),
    "dehaze": BenchSpec(_paired("dehazing/SOTS/outdoor/hazy",
                                "dehazing/SOTS/outdoor", dehaze_rule=True)),
    # mixed-size sets: bucket pads to x64 to bound the number of shapes
    "deblur": BenchSpec(_paired("deblurring/GoPro/test/input",
                                "deblurring/GoPro/test/target"),
                        dict(bucket=64)),
    "synllie": BenchSpec(_paired("llie/LOLv1/Test/input",
                                 "llie/LOLv1/Test/target"),
                         dict(bucket=64)),
    # TransWeather benchmarks (test_raindrop.py, test_snow100k.py:42-70)
    "raindrop": BenchSpec(_paired("weather/RainDrop/input",
                                  "weather/RainDrop/gt"),
                          dict(bucket=64)),
    "snow100k_l": BenchSpec(_paired("weather/Snow100K-L/input",
                                    "weather/Snow100K-L/gt"),
                            dict(bucket=64)),
    "snow100k_s": BenchSpec(_paired("weather/Snow100K-S/input",
                                    "weather/Snow100K-S/gt"),
                            dict(bucket=64)),
    # CDD-11 (fixed 64px crops)
    "cdd11": _cdd11("all"),
    "cdd11_single": _cdd11("single"),
    "cdd11_double": _cdd11("double"),
    "cdd11_triple": _cdd11("triple"),
    # SR (SRConvNet benchmark.py layout; DIV2K valid uses the same shape)
    **{f"sr_{s}_x{k}": _sr(S, k)
       for s, S in [("set5", "Set5"), ("set14", "Set14"), ("b100", "B100"),
                    ("urban100", "Urban100"), ("div2k", "DIV2K_valid")]
       for k in (2, 3, 4)},
}

# AdaIR test.py --mode int switch (test.py:101-102)
MODE_TO_BENCHMARKS = {
    0: ["denoise_15", "denoise_25", "denoise_50"],
    1: ["derain"],
    2: ["dehaze"],
    3: ["denoise_25", "derain", "dehaze"],  # aio-3
    4: ["deblur"],
    5: ["synllie"],
    6: ["denoise_25", "derain", "dehaze", "deblur", "synllie"],  # aio-5
}


def run_benchmark(bench: str, fn, data_root: str, **kw) -> BenchResult:
    """Protocol kwargs come from the BenchSpec; caller kwargs (tile,
    save_dir, lpips_fn, pad override, device...) win on conflict."""
    if bench not in BENCHMARKS:
        raise KeyError(f"unknown benchmark {bench}; have {sorted(BENCHMARKS)}")
    spec = BENCHMARKS[bench]
    ds = spec.factory(data_root)
    merged = {**spec.eval_kw, **kw}
    return evaluate(fn, ds, name=bench, **merged)
