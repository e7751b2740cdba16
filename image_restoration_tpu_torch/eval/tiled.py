"""Whole-image inference helpers (image_restoration_tpu/eval/tiled.py)."""

from __future__ import annotations

from image_restoration_tpu_torch.ops.common import crop_to, pad_to_multiple


def pad_test(fn, x, multiple: int, mode: str = "reflect", scale: int = 1):
    """Pad an NCHW batch to a multiple, run ``fn``, crop back
    (image_restoration_model.py:326-338). ``scale`` > 1 for SR models whose
    output is scale-x larger: the crop keeps (H*scale, W*scale)."""
    xp, hw = pad_to_multiple(x, multiple, mode)
    out = fn(xp)
    return crop_to(out, (hw[0] * scale, hw[1] * scale))
