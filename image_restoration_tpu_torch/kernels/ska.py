"""SKA dynamic convolution, forward, as one CUDA kernel launch.

Port of image_restoration_tpu/kernels/ska_pallas.py ``_ska_forward``: LSNet's
LSConv aggregates each pixel's 3x3 neighbourhood of x with the per-pixel
weights LKP predicts (ops/ska.py gives the formula). :func:`ska` takes
(B, H, W, C) x and (B, H, W, wc, k^2) w in bf16 or fp32, any H and W, any C
with C % wc == 0 and an odd k, and returns (B, H, W, C) in x's dtype.

On a CUDA tensor it launches ``csrc/ska.cu`` or raises; on a CPU tensor it
runs :func:`~image_restoration_tpu_torch.ops.ska.ska_plain`. ``ska.launches``
counts launches. Forward only: serving does not differentiate SKA, and its
backward comes with LSNet training.
"""

from __future__ import annotations

import torch

from image_restoration_tpu_torch.ops.ska import ska_plain, ska_shape


def ska(x, w):
    """SKA of x (B, H, W, C) with w (B, H, W, wc, k^2); see the module."""
    if x.device.type == "cpu":
        return ska_plain(x, w)
    from image_restoration_tpu_torch.kernels.build import load_library

    b, h, wd, c, wc, ks = ska_shape(x, w)
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"ska: {name} is on {t.device}; the kernel "
                             f"takes x and w on one CUDA device")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != x.dtype:
            raise TypeError(f"ska: the kernel takes bfloat16 or float32 x and "
                            f"w of one dtype, got {x.dtype} and {w.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ska: {name} must be contiguous")
    lib = load_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lib.ir_ska(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              b, h, wd, c, wc, ks,
                              int(x.dtype == torch.float32), stream)
    lib.check(code, "ska")
    ska.launches += 1
    return out


ska.launches = 0
