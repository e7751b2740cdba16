"""SKA dynamic convolution, forward, as one CUDA kernel launch.

Port of image_restoration_tpu/kernels/ska_pallas.py ``_ska_forward``: LSNet's
LSConv aggregates each pixel's 3x3 neighbourhood of x with the per-pixel
weights LKP predicts (ops/ska.py gives the formula). :func:`ska` takes
(B, H, W, C) x and (B, H, W, wc, k^2) w in bf16 or fp32, any H and W, any C
with C % wc == 0 and an odd k, and returns (B, H, W, C) in x's dtype.

At k = 3 with wc a multiple of 8 (every LSNet width) ``csrc/ska.cu`` runs
its strip kernel: blocks take strips of whole image rows staged in shared
memory; persistent ones (as many as the card holds, measured once per
shape by the occupancy API and cached) load the next strips while the
current one runs. Rows a strip, strip slots and the threads a unit's
channel repeats are split over come from per-width tables (``_SKA_*``),
chosen by ``chip_smoke.py --ska`` sweeps; the kernel sizes its blocks from
them. Rows too wide for the table's strip to fit in shared memory take
one-row strips, one a block; rows too wide for those, other shapes and
unaligned views take the kernel's scalar path.

On a CUDA tensor it launches ``csrc/ska.cu`` or raises; on a CPU tensor it
runs :func:`~image_restoration_tpu_torch.ops.ska.ska_plain`. ``ska.launches``
counts launches. Forward only: on CUDA tensors that require grad
``backward()`` raises (``kernels/forward_only.py``); SKA's backward comes
with LSNet training.
"""

from __future__ import annotations

import contextlib

import torch

from image_restoration_tpu_torch.kernels.forward_only import forward_only
from image_restoration_tpu_torch.ops.ska import ska_plain, ska_shape

# Launch tables of the strip kernel by (C, bytes a value), chosen by
# ``chip_smoke.py --ska`` sweeps at LSNet-B's batch-64 shapes (28x28 x 128,
# 14x14 x 256, 7x7 x 384) on an H100 80GB HBM3 (700 W): rows a strip,
# strip slots (1: one strip a block; 2: persistent blocks loading the
# next strip ahead) and the threads that share a (pixel, 8 weight
# channels) unit's channel repeats. fp32 strips take twice the shared
# memory, so the deeper fp32 maps run 4-row strips one a block.
_SKA_ROWS = {(128, 2): 2, (256, 2): 2, (384, 2): 2,
             (128, 4): 2, (256, 4): 4, (384, 4): 4}
_SKA_RING = {(128, 2): 2, (256, 2): 2, (384, 2): 2,
             (128, 4): 2, (256, 4): 1, (384, 4): 1}
_SKA_SPLIT = {(384, 2): 2}


def _config(c, esize):
    """(rows a strip, slots, split) at width ``c``; 2 rows, 2 slots and no
    split where the tables have no entry."""
    key = (c, esize)
    return (_SKA_ROWS.get(key, 2), _SKA_RING.get(key, 2),
            _SKA_SPLIT.get(key, 1))


_PLANS = {}


def _plan(lib, device, b, h, w, c, wc, fp32):
    """(rows a strip, slots, split, blocks) of a launch: the tables' strip
    or, where it does not fit the card, one-row strips one a block, on the
    SMs times the blocks an SM holds, no more than the strips (0 blocks
    where neither fits: the scalar path ignores them); cached per shape."""
    th, ring, split = _config(c, 4 if fp32 else 2)
    key = (device, b, h, w, c, wc, fp32, th, ring, split)
    if key not in _PLANS:
        with torch.cuda.device(device):
            per_sm = lib.lib.ir_ska_blocks(w, c, wc, fp32, th, ring, split)
            if not per_sm:
                th, ring = 1, 1
                per_sm = lib.lib.ir_ska_blocks(w, c, wc, fp32, th, ring,
                                               split)
            sms = torch.cuda.get_device_properties(device).multi_processor_count
        _PLANS[key] = (th, ring, split, min(b * -(-h // th), per_sm * sms))
    return _PLANS[key]


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
    fp32 = int(x.dtype == torch.float32)
    plan = _plan(lib, x.device, b, h, wd, c, wc, fp32)

    def launch():
        out = torch.empty_like(x)
        idx = x.device.index
        # a device switch and a Stream object took a third of a call's host
        # time (chip_smoke.py --ska times the parts): switch only when x is
        # not on the current device, and take the raw stream handle
        with (contextlib.nullcontext() if idx == torch.cuda.current_device()
              else torch.cuda.device(idx)):
            code = lib.lib.ir_ska(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  b, h, wd, c, wc, ks, fp32, *plan,
                                  torch._C._cuda_getCurrentRawStream(idx))
        lib.check(code, "ska")
        ska.launches += 1
        return out

    return forward_only("ska", (x, w), launch)


ska.launches = 0
