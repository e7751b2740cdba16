"""Benchmark evaluation entry point — the `src/test.py` surface
(image_restoration_tpu/cli/test.py; MoCE-IR-main/src/test.py:166-209 call
stack; AdaIR test.py --mode switch), and the checkpoint loading the port's
entry points share.

Usage:
  python -m image_restoration_tpu_torch.cli.test --model restormer \
      --ckpt restormer.pth --benchmarks derain denoise_25 --data_file_dir data/

  # AdaIR's --mode switch (eval/benchmarks.py MODE_TO_BENCHMARKS), tiled
  python -m image_restoration_tpu_torch.cli.test --model adair \
      --ckpt adair.pth --mode 3 --tile 128 --data_file_dir data/

Prints one line per benchmark and writes ``results.json`` under
``--output_dir``, as the JAX CLI does. The forward runs on the GPU unless
``--device cpu`` is given, with TF32 off (``utils/precision.py``
``full_fp32``, the JAX CLI's "highest"); on the GPU Restormer and AdaIR run
every block through K1/K2 and DRSformer through K1/K7/K8 (``cli/infer.py``),
as do CG-IR, MEASNet and NeRD-Rain (K1/K2; NeRD-Rain pads to multiples of
16 unless ``--pad_multiple`` is given) and MoCE-IR's encoder (K1/K2);
IGMoCE-IR, LumiSenseMoE, the patch-routed MoCE-IR, SRConvNet (the
``sr_*`` benchmarks), TransWeather and DarkIR run in plain torch.
``--lpips_ckpt`` adds an LPIPS column (``eval/perceptual.py``).
``--unpaired --lq_dir DIR --niqe_params P`` scores a folder without
ground truth by NIQE (:func:`run_unpaired`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _unflatten(flat):
    """Flat ``a.b.c`` keys (the JAX package's ``save_params_npz``) to a
    nested dict."""
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *mods, leaf = key.split(".")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.asarray(arr)
    return tree


def _map_keys(sd, own, key_map):
    """A torch checkpoint's keys that the model does not hold, through the
    model's key map: dropped where it gives None, renamed where it gives a
    key the model holds (MoCE-IR's reference ``.layers.`` level), kept as
    they are otherwise, so that the strict load names them."""
    out = {}
    for k, v in sd.items():
        if k in own:
            out[k] = v
        elif (mapped := key_map(k)) is not None:
            out[mapped if mapped in own else k] = v
    return out


def load_params(cfg, model):
    """Load ``cfg["ckpt"]`` into ``model`` with a strict ``load_state_dict``.

    Torch ``.pth/.pt/.ckpt/.state`` files go through the envelope handling of
    ``utils.torch_import``; a ``.npz`` exported by the JAX package goes
    through ``utils.jax_bridge``, with the key map ``cfg["model"]`` was
    registered with; it holds params only, so BatchNorm statistics (LSNet)
    stay at the model's init, as in the JAX ``cli/robust.py``. From a torch
    checkpoint, keys the model does not hold go through the key map first
    (:func:`_map_keys`): those it sends to None are dropped (parameters the
    reference defines but never uses, such as AdaIR's ``fre*.conv`` and
    ``fre*.score_gen``, and MoCE-IR's ``routing.complexity`` statistic), and
    those it renames to a key of the model take that key (MoCE-IR's
    ``.layers.`` level). A model with a ``checkpoint_key_map`` method
    (IPT, whose map depends on its task) maps through that instead of the
    registered map. Without ``--ckpt`` the model keeps its random init.
    Returns the model.
    """
    path = cfg.get("ckpt")
    if not path:
        print("WARNING: no --ckpt given; using random init")
        return model
    from image_restoration_tpu_torch.models import KEY_MAPS

    key_map = getattr(model, "checkpoint_key_map", None) or KEY_MAPS.get(
        str(cfg.get("model", "")).lower())
    if path.endswith(".npz"):
        from image_restoration_tpu_torch.utils.jax_bridge import (
            state_dict_from_jax,
        )

        with np.load(path) as data:
            tree = _unflatten(dict(data))
        sd = state_dict_from_jax(tree, model.state_dict(), key_map)
    elif path.endswith((".pth", ".pt", ".ckpt", ".state")):
        from image_restoration_tpu_torch.utils.torch_import import (
            load_torch_checkpoint,
        )

        sd = load_torch_checkpoint(path, prefer_ema=cfg.get("prefer_ema", False))
        if key_map is not None:
            sd = _map_keys(sd, model.state_dict(), key_map)
    else:
        raise ValueError(f"{path}: the port reads torch .pth/.pt/.ckpt/.state "
                         f"and JAX .npz checkpoints (export orbax runs with "
                         f"save_params_npz)")
    model.load_state_dict(sd, strict=True)
    return model


def make_eval_fn(model):
    """The benchmark forward: (B, C, H, W) -> the model's restored image,
    under ``torch.inference_mode()`` with TF32 off, a tuple output unwrapped
    to its first element (JAX ``cli/test.py:105-115``)."""
    from image_restoration_tpu_torch.utils.precision import full_fp32

    def fn(x):
        with torch.inference_mode(), full_fp32():
            out = model(x)
        if isinstance(out, tuple):
            out = out[0]
        return out

    return fn


def make_lpips_fn(path, device):
    """The LPIPS column (MoCE-IR-main/src/test.py:88,105,123): ``(out, gt)
    -> (B,)`` distances of the port's ``LPIPS`` with the weights of the
    torch checkpoint ``path`` (the VGG16 trunk under ``net.`` and the
    heads, through ``lpips_key_map``; strict), in fp32 with TF32 off."""
    from image_restoration_tpu_torch.eval.perceptual import (
        LPIPS, lpips_key_map,
    )
    from image_restoration_tpu_torch.utils.precision import full_fp32
    from image_restoration_tpu_torch.utils.torch_import import (
        load_torch_checkpoint,
    )

    lp = LPIPS()
    sd = {lpips_key_map(k): v for k, v in load_torch_checkpoint(path).items()}
    lp.load_state_dict(sd, strict=True)
    lp = lp.to(device).eval()

    def fn(out, gt):
        with torch.inference_mode(), full_fp32():
            return lp(out.float(), gt.float())

    return fn


def run_unpaired(cfg, model):
    """No-ground-truth evaluation (JAX ``cli/test.py`` ``run_unpaired``;
    DarkIR-main/testing_unpaired.py's protocol with the repo's NIQE):
    restore every image under ``--lq_dir`` (or ``--input``) through
    ``cli/infer.py`` ``make_restore_fn`` on the model's device, score the
    NIQE of each output and of each input on the host with the pristine
    parameters of ``--niqe_params`` (``eval/niqe.py``), print their means
    and write ``results.json`` with ``unpaired.n``, ``niqe`` and
    ``niqe_input``; ``--save_images DIR`` writes the outputs."""
    from image_restoration_tpu_torch.cli.infer import (
        list_images, load_image, make_restore_fn, save_image,
    )
    from image_restoration_tpu_torch.eval.niqe import calculate_niqe

    src = cfg.get("lq_dir") or cfg.get("input")
    if not src:
        raise SystemExit("--unpaired needs --lq_dir (folder of inputs)")
    restore = make_restore_fn(cfg, model)
    out_dir = cfg.get("output_dir", "results")
    os.makedirs(out_dir, exist_ok=True)
    niqe_in, niqe_out = [], []
    for p in list_images(src):
        img = load_image(p)
        res = restore(img)
        niqe_in.append(calculate_niqe(img, params_path=cfg.get("niqe_params")))
        niqe_out.append(calculate_niqe(res,
                                       params_path=cfg.get("niqe_params")))
        if cfg.get("save_images"):
            save_image(os.path.join(cfg["save_images"], os.path.basename(p)),
                       res)
    results = {"unpaired": {"n": len(niqe_out),
                            "niqe": float(np.mean(niqe_out)),
                            "niqe_input": float(np.mean(niqe_in))}}
    print(f"unpaired: NIQE {results['unpaired']['niqe']:.4f} "
          f"(input {results['unpaired']['niqe_input']:.4f}) | "
          f"{len(niqe_out)} images")
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    from image_restoration_tpu_torch.cli.train import (
        build_model, refuse_layers,
    )
    from image_restoration_tpu_torch.eval.benchmarks import (
        MODE_TO_BENCHMARKS, run_benchmark,
    )
    from image_restoration_tpu_torch.utils.options import parse_options

    cfg = parse_options(argv)
    refuse_layers(cfg)
    model = load_params(cfg, build_model(cfg))
    if cfg.get("unpaired"):
        return run_unpaired(cfg, model)
    device = next(model.parameters()).device
    fn = make_eval_fn(model)

    benches = cfg["benchmarks"]
    if cfg.get("mode") is not None:
        benches = MODE_TO_BENCHMARKS[cfg["mode"]]

    extra_kw = {"device": device}
    if cfg.get("pad_multiple", 8) != 8:  # explicit override beats protocol
        extra_kw["pad_multiple"] = cfg["pad_multiple"]
    if cfg.get("tile"):
        extra_kw["tile"] = cfg["tile"]
    if cfg.get("save_images"):
        extra_kw["save_dir"] = cfg["save_images"]
    if cfg.get("lpips_ckpt"):
        extra_kw["lpips_fn"] = make_lpips_fn(cfg["lpips_ckpt"], device)

    results = {}
    for b in benches:
        r = run_benchmark(b, fn, cfg["data_file_dir"], **extra_kw)
        results[b] = {"psnr": r.psnr, "ssim": r.ssim, "n": r.n, **r.extra}
        cols = f"{b}: PSNR {r.psnr:.4f} dB | SSIM {r.ssim:.4f}"
        if "lpips" in r.extra:
            cols += f" | LPIPS {r.extra['lpips']:.4f}"
        print(cols + f" | {r.n} images")

    out_dir = cfg.get("output_dir", "results")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
