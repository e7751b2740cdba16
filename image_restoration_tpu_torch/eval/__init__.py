"""Evaluation: PSNR/SSIM protocols, whole-image and tiled inference, the
restoration benchmarks and the classification robustness protocol."""

from image_restoration_tpu_torch.eval.metrics import (  # noqa: F401
    psnr,
    masked_psnr,
    ssim,
    masked_ssim,
    rgb_to_y,
    psnr_yc,
    ssim_yc,
)
from image_restoration_tpu_torch.eval.tiled import (  # noqa: F401
    window_partition,
    window_reverse,
    windowed_apply,
    pad_test,
)
