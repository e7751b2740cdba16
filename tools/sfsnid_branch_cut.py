"""Where two fp32 runs of the port's SFSNiD part, and why: the angle's
branch cut.

SFSNiD's spectrum blocks (``models/demo_models.py`` ``FreqSpectrumSE``)
add a 1x1-conv branch to ``angle(z)`` of every rfft2 coefficient. The
angle jumps by 2 pi where z crosses the negative real axis; cos and sin
of the phase do not see the jump, but the branch's convs do, so a
coefficient whose imaginary part lies within rounding of 0 while its real
part is negative gives two runs phases on either side of the cut, and
outputs that differ by O(1) at that frequency in every channel.

The model (``MODEL_DEFAULTS``, seed-0 init, fp32, TF32 off) runs on
chip_smoke.py phase 3q's seeded 64x64 image on the CPU, then again: with
the image moved by a seeded 1e-7 a pixel on the CPU, and, where a CUDA
device is present, as it is on the card. For each stage, in the order the
forward finishes them, each rerun's output against the first run's
(relative L2) and the coefficients that crossed the cut so far (their
angles more than pi apart at the input of a ``FreqSpectrumSE``).

Usage:  python tools/sfsnid_branch_cut.py
"""

from __future__ import annotations

import copy
import math
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from image_restoration_tpu_torch.cli.train import build_model  # noqa: E402
from image_restoration_tpu_torch.models.demo_models import (  # noqa: E402
    FreqSpectrumSE,
)
from image_restoration_tpu_torch.utils.options import (  # noqa: E402
    parse_options,
)
from image_restoration_tpu_torch.utils.precision import (  # noqa: E402
    full_fp32,
)

STAGES = (r"SCM\d|feat_extract\.\d|FeatureMerge\d\.merge|(Encoder|Decoder)\.\d"
          r"|Convs\.\d|ConvsOut\.\d")


def trace(model, x):
    """In call order: ("stage", name, its output) at each stage's end and
    ("angle", name, angle of its input) at each ``FreqSpectrumSE``'s
    start, on the CPU in float64."""
    events = []
    hooks = []
    for name, mod in model.named_modules():
        if re.fullmatch(STAGES, name):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, n=name: events.append(
                    ("stage", n, o.double().cpu()))))
        elif isinstance(mod, FreqSpectrumSE):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, i, n=name: events.append(
                    ("angle", n, torch.angle(i[0]).double().cpu()))))
    try:
        with torch.inference_mode(), full_fp32():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return events


def main():
    cfg = parse_options(["--model", "sfsnid", "--device", "cpu", "--seed",
                         "0"])
    model = build_model(dict(cfg, bf16=False), device="cpu").eval()
    x = torch.rand((1, 3, 64, 64),
                   generator=torch.Generator().manual_seed(3520))
    dx = 1e-7 * torch.randn(x.shape,
                            generator=torch.Generator().manual_seed(1))
    base = trace(model, x)
    reruns = {"CPU, input moved by 1e-7": trace(model, x + dx)}
    if torch.cuda.is_available():
        card = copy.deepcopy(model).cuda()
        reruns[torch.cuda.get_device_name(0)] = trace(card, x.cuda())
    print("SFSNiD (num_res 3, base 32), seed-0 init, fp32, a 64x64 image; "
          "each rerun against the CPU's run: relative L2 of each stage's "
          "output, and the rfft2 coefficients that crossed the angle's "
          "branch cut so far")
    for tag, events in reruns.items():
        print(f"-- {tag}")
        crossed = 0
        for (kind, name, want), (_, _, got) in zip(base, events):
            if kind == "angle":
                crossed += int(((got - want).abs() > math.pi).sum())
            else:
                rel = float((got - want).norm() / want.norm())
                print(f"   {name:20s} {rel:.3e}  crossed {crossed}")


if __name__ == "__main__":
    main()
