"""SKA dynamic convolution as one CUDA kernel launch, and its backward as
two.

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
counts launches. The forward is the custom op ``ir_torch::ska``
(:func:`ska_op`, with a fake implementation for tracing), so
``torch.export`` keeps the kernel in an exported LSNet.

:func:`ska` differentiates as the JAX ``ska_pallas`` custom VJP does
(``ska_pallas.py:99-138``): the forward keeps x and w, and the backward
(:class:`_SKA`) computes ``_ska_bwd``'s gradients, on CUDA tensors with
the two kernels of ``csrc/ska_bwd.cu`` (:func:`ska_bwd_x`,
:func:`ska_bwd_w`, each counting its launches), on CPU tensors with
:func:`~image_restoration_tpu_torch.ops.ska.ska_bwd_plain`.
"""

from __future__ import annotations

import contextlib

import torch

from image_restoration_tpu_torch.ops.ska import (
    ska_bwd_plain,
    ska_plain,
    ska_shape,
)

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


def _check(what, pairs):
    """Raises on what the kernels do not take: tensors on one CUDA device,
    contiguous, all bfloat16 or all float32."""
    dev, dt = pairs[0][1].device, pairs[0][1].dtype
    for name, t in pairs:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}; the kernel "
                             f"takes its tensors on one CUDA device")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != dt:
            raise TypeError(f"{what}: the kernel takes bfloat16 or float32 "
                            f"tensors of one dtype, got "
                            f"{[u.dtype for _, u in pairs]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _stream(idx):
    """A device switch and a Stream object took a third of a call's host
    time (``chip_smoke.py --ska`` times the parts): switch only when the
    tensors are not on the current device, and take the raw stream
    handle."""
    return (contextlib.nullcontext() if idx == torch.cuda.current_device()
            else torch.cuda.device(idx))


def _ska(x, w):
    if x.device.type == "cpu":
        return ska_plain(x, w)
    from image_restoration_tpu_torch.kernels.build import load_library

    b, h, wd, c, wc, ks = ska_shape(x, w)
    _check("ska", [("x", x), ("w", w)])
    lib = load_library()
    fp32 = int(x.dtype == torch.float32)
    plan = _plan(lib, x.device, b, h, wd, c, wc, fp32)
    out = torch.empty_like(x)
    idx = x.device.index
    with _stream(idx):
        code = lib.lib.ir_ska(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              b, h, wd, c, wc, ks, fp32, *plan,
                              torch._C._cuda_getCurrentRawStream(idx))
    lib.check(code, "ska")
    ska.launches += 1
    return out


@torch.library.custom_op("ir_torch::ska", mutates_args=())
def ska_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward launch as a ``torch.library`` custom op, so that
    ``torch.export`` records it as one node (``train/distill.py``
    ``export_program``) and a loaded program launches the kernel."""
    return _ska(x, w)


@ska_op.register_fake
def _ska_fake(x, w):
    ska_shape(x, w)
    return torch.empty_like(x)


class _SKA(torch.autograd.Function):
    """The JAX ``ska_pallas`` custom VJP: ``_ska_fwd`` keeps (x, w),
    ``_ska_bwd`` computes gx and gw from them and the output gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return ska_op(x, w)

    @staticmethod
    def backward(ctx, go):
        x, w = ctx.saved_tensors
        go = go.to(x.dtype).contiguous()
        if go.device.type == "cpu":
            return ska_bwd_plain(x, w, go)
        need_x, need_w = ctx.needs_input_grad
        return (ska_bwd_x(x, w, go) if need_x else None,
                ska_bwd_w(x, w, go) if need_w else None)


def ska(x, w):
    """SKA of x (B, H, W, C) with w (B, H, W, wc, k^2); see the module.
    Differentiable in x and w (:class:`_SKA`); without a gradient to take,
    this is the launch itself."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _SKA.apply(x, w)
    return ska_op(x, w)


ska.launches = 0


def _bwd_launch(entry, counter, out, operand, go, x, w):
    """Launches ``ir_<entry>`` on (go, operand) into ``out``."""
    from image_restoration_tpu_torch.kernels.build import load_library

    bsz, h, wd, c, wc, ks = ska_shape(x, w)
    _check(entry, [("go", go), ("x", x), ("w", w)])
    if go.shape != x.shape:
        raise ValueError(f"{entry}: go {tuple(go.shape)} is not x's shape "
                         f"{tuple(x.shape)}")
    lib = load_library()
    idx = go.device.index
    with _stream(idx):
        code = getattr(lib.lib, f"ir_{entry}")(
            go.data_ptr(), operand.data_ptr(), out.data_ptr(), bsz, h, wd, c,
            wc, ks, int(go.dtype == torch.float32),
            torch._C._cuda_getCurrentRawStream(idx))
    lib.check(code, entry)
    counter.launches += 1
    return out


def ska_bwd_x(x, w, go):
    """gx (B, H, W, C) in x's dtype: SKA's gradient in x at (x, w) under
    the output gradient ``go`` (x's shape and dtype). x gives only the
    shape; the kernel (``csrc/ska_bwd.cu``) reads go and w."""
    if go.device.type == "cpu":
        return ska_bwd_plain(x, w, go)[0]
    return _bwd_launch("ska_bwd_x", ska_bwd_x, torch.empty_like(go), w, go,
                       x, w)


ska_bwd_x.launches = 0


def ska_bwd_w(x, w, go):
    """gw (B, H, W, wc, k^2) in w's dtype: SKA's gradient in w at (x, w)
    under the output gradient ``go``; the kernel reads go and x."""
    if go.device.type == "cpu":
        return ska_bwd_plain(x, w, go)[1]
    return _bwd_launch("ska_bwd_w", ska_bwd_w, torch.empty_like(w), x, go,
                       x, w)


ska_bwd_w.launches = 0
