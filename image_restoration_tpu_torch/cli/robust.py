"""Robustness-evaluation CLI for the classification models
(image_restoration_tpu/cli/robust.py): point any of ``--inc_path``
(ImageNet-C tree), ``--ina_path`` / ``--inr_path`` (ImageNet-A/R, masked to
their 200-class subsets) and ``--insk_path`` (ImageNet-Sketch) at
ImageFolder trees.

    python -m image_restoration_tpu_torch.cli.robust --model lsnet \\
        --ckpt lsnet_t.pth --inc_path /data/imagenet-c --input_size 224

The model is LSNet-T unless ``--set model_kwargs.*`` says otherwise
(``utils/options.py``), fp32 as the JAX CLI classifies unless ``--bf16``,
on the GPU unless ``--device cpu``; on the GPU every LSConv runs SKA as the
CUDA kernel of ``kernels/ska.py``. ``--adv FGSM|PGD`` attacks the
ImageNet-A/R/Sketch batches before scoring them (``eval/robustness.py``
``fgsm_pgd_attack``), differentiating every SKA through its backward
kernels on the GPU.
"""

from __future__ import annotations

import json
import os


def build_argparser():
    from image_restoration_tpu_torch.utils.options import build_parser

    p = build_parser()
    p.description = __doc__.splitlines()[0]
    # the protocol's numbers are fp32 ones (the JAX CLI builds LSNet with
    # its default dtype); --bf16 stays reachable
    p.set_defaults(model="lsnet", bf16=False)
    p.add_argument("--inc_path", default=None)
    p.add_argument("--ina_path", default=None)
    p.add_argument("--inr_path", default=None)
    p.add_argument("--insk_path", default=None)
    p.add_argument("--train_classes", default=None,
                   help="dir whose sorted subdirs define the 1000-class "
                        "wnid order (defaults to the eval set's own classes)")
    p.add_argument("--adv", default=None, choices=["FGSM", "PGD"])
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--out_json", default=None)
    return p


def main(argv=None):
    from image_restoration_tpu_torch.cli.test import load_params
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.eval import robustness as R
    from image_restoration_tpu_torch.utils.options import parse_options

    cfg = parse_options(argv, build_argparser())
    model = load_params(cfg, build_model(cfg))
    results = {}
    if cfg["inc_path"]:
        results["imagenet_c"] = R.imagenet_c_eval(
            model, cfg["inc_path"], cfg["batch_size"], cfg["input_size"])

    for key, path, subset in (("imagenet_a", cfg["ina_path"], "a"),
                              ("imagenet_r", cfg["inr_path"], "r"),
                              ("imagenet_sketch", cfg["insk_path"], None)):
        if not path:
            continue
        mask = None
        if subset is not None:
            from image_restoration_tpu_torch.eval.robust_subsets import (
                IMAGENET_A_WNIDS,
                IMAGENET_R_WNIDS,
            )

            cls_dir = cfg["train_classes"] or path
            all_wnids = sorted(d for d in os.listdir(cls_dir)
                               if os.path.isdir(os.path.join(cls_dir, d)))
            wnids = IMAGENET_A_WNIDS if subset == "a" else IMAGENET_R_WNIDS
            mask = R.subset_logit_mask(all_wnids, wnids)
        stats = R.evaluate_folder(model, path, cfg["batch_size"],
                                  cfg["input_size"], mask=mask,
                                  adv=cfg["adv"])
        print(f"Accuracy on the {key}: {stats['acc1']:.1f}%")
        results[key] = stats

    if cfg["out_json"]:
        with open(cfg["out_json"], "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
