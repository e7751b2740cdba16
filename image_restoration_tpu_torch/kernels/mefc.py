"""MEFC op-mixture steps, one kernel launch per step.

Port of image_restoration_tpu/kernels/mefc_pallas.py. DRSformer's MEFC
Subnet (DRSformer_arch.py:189-353) runs ``steps`` residual steps; each
applies an 8-op bank to the same input,

  SepConv k in (1, 3, 5, 7):  dw_k -> 1x1 -> relu -> dw_k -> 1x1
  DilConv k in (3, 5, 7):     dilation-2 dw_k -> 1x1
  AvgPool 3x3, count_include_pad=False,

scales each op's output by its per-sample mix weight, concatenates, and
ends with a 1x1, relu, + input, relu. Each op's last 1x1, its block of the
concat 1x1 and its mix weight fold into one per-batch (C, C) matrix M_op
(:func:`fold_step`, plain torch), so a step is taps [-> 1x1 -> relu ->
taps] -> M_op per op, summed, then relu(relu(sum) + x): one pass of
:func:`mefc_step` (CUDA ``csrc/mefc_step.cu``) with every intermediate on
chip. Everything is bias-free, as in the reference.

On a CUDA tensor :func:`mefc_step` launches its kernel or raises; on a CPU
tensor it runs :func:`mefc_step_ref`, which rounds where the kernel rounds
when given bf16 and does not round at all in fp32. ``mefc_step.launches``
counts launches. Forward only: on CUDA
tensors that require grad ``backward()`` raises
(``kernels/forward_only.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from image_restoration_tpu_torch.kernels.block import (
    _check_input,
    _matmul_1x1,
    _pick_tile_rows,
    _tiles,
)
from image_restoration_tpu_torch.kernels.forward_only import forward_only

Tensor = torch.Tensor

SEP_KS = (1, 3, 5, 7)
DIL_KS = (3, 5, 7)
NUM_OPS = 8  # sep1, sep3, sep5, sep7, dil3, dil5, dil7, pool


class StepParams(NamedTuple):
    """One op-mixture step's parameters in torch layout (fp32)."""

    sep_dwa: List[Tensor]      # 4 x (C, 1, k, k), k = 1, 3, 5, 7
    sep_w1: List[Tensor]       # 4 x (C, C, 1, 1)
    sep_dwb: List[Tensor]      # 4 x (C, 1, k, k)
    sep_w2: List[Tensor]       # 4 x (C, C, 1, 1)
    dil_dw: List[Tensor]       # 3 x (C, 1, k, k), k = 3, 5, 7, dilation 2
    dil_w1: List[Tensor]       # 3 x (C, C, 1, 1)
    wcat: Tensor               # (C, 8C, 1, 1): the concat 1x1


# ------------------------------------------------------------ plain parts ---

def avg_pool3x3_exclude_pad(x):
    """AvgPool2d(3, stride 1, pad 1, count_include_pad=False), NCHW."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _io(w):
    """A 1x1 conv weight (O, I, 1, 1) as an fp32 (I, O) matrix."""
    return w.reshape(w.shape[0], -1).t().float()


def fold_step(sp: StepParams, mix, dtype):
    """M (B, 8, C, C) in ``dtype``: M_op = mix[:, op] * W_last_op @ Wcat_op,
    in fp32 and then rounded (mefc_pallas.py:266-296, 365-369).

    ``mix`` (B, 8) is the step's mix weights in the compute dtype, as the
    Subnet casts them; the pool's W_last is the identity.
    """
    c = sp.wcat.shape[0]
    wcat = _io(sp.wcat)
    lasts = [_io(w) for w in sp.sep_w2] + [_io(w) for w in sp.dil_w1]
    last = torch.stack([w @ wcat[i * c:(i + 1) * c]
                        for i, w in enumerate(lasts)]
                       + [wcat[7 * c:]])
    return (mix.float()[:, :, None, None] * last).to(dtype)


def _dw(t, w, padding, dilation=1):
    """Zero-padded depthwise conv of a (B, H, W, C) fp32 tensor."""
    y = F.conv2d(t.permute(0, 3, 1, 2), w.float(), padding=padding,
                 dilation=dilation, groups=t.shape[-1])
    return y.permute(0, 2, 3, 1)


def mefc_step_ref(x, sp: StepParams, m):
    """Plain version of :func:`mefc_step`; output in x's dtype.

    Rounds to x's dtype where the TPU kernel rounds (its ``_F32_MIX`` off):
    each tap sum before its product, and the relu'd t1.
    """
    dt = x.dtype
    b, h, w, c = x.shape
    xf = x.float()
    mf = m.float()

    def mixed(t, op):
        return torch.bmm(t.to(dt).float().reshape(b, h * w, c), mf[:, op])

    out = 0.0
    for i, k in enumerate(SEP_KS):
        a1 = _dw(xf, sp.sep_dwa[i], k // 2).to(dt).float()
        t1 = torch.relu(_matmul_1x1(a1, sp.sep_w1[i], None, dt)).to(dt).float()
        out = out + mixed(_dw(t1, sp.sep_dwb[i], k // 2), i)
    for i, k in enumerate(DIL_KS):
        out = out + mixed(_dw(xf, sp.dil_dw[i], k - 1, 2), 4 + i)
    pool = avg_pool3x3_exclude_pad(xf.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    out = out + mixed(pool, 7)
    return torch.relu(torch.relu(out.reshape(b, h, w, c)) + xf).to(dt)


def reference_steps(x, steps: List[StepParams], weights):
    """The op-mixture steps as the plain composition of their ops, on
    (B, H, W, C): counterpart of the JAX ``mefc_pallas._reference_steps``.
    Every conv runs in x's dtype; ``weights`` (B, steps, 8)."""
    dt = x.dtype

    def conv(t, wt, groups=1, padding=0, dilation=1):
        out = F.conv2d(t.permute(0, 3, 1, 2), wt.to(dt), padding=padding,
                       dilation=dilation, groups=groups)
        return out.permute(0, 2, 3, 1)

    c = x.shape[-1]
    for st, sp in enumerate(steps):
        outs = []
        for i, k in enumerate(SEP_KS):
            t = conv(x, sp.sep_dwa[i], c, k // 2)
            t = conv(torch.relu(conv(t, sp.sep_w1[i])), sp.sep_dwb[i], c, k // 2)
            outs.append(conv(t, sp.sep_w2[i]))
        for i, k in enumerate(DIL_KS):
            outs.append(conv(conv(x, sp.dil_dw[i], c, k - 1, 2), sp.dil_w1[i]))
        outs.append(avg_pool3x3_exclude_pad(x.permute(0, 3, 1, 2))
                    .permute(0, 2, 3, 1))
        cat = torch.cat([o * weights[:, st, i].to(dt)[:, None, None, None]
                         for i, o in enumerate(outs)], dim=-1)
        x = torch.relu(torch.relu(conv(cat, sp.wcat)) + x)
    return x


# ---------------------------------------------------------------- kernels ---

def _taps(ws):
    """Depthwise weights [(C, 1, k, k)] -> fp32 (sum k^2, C), tap-major."""
    return torch.cat([w.reshape(w.shape[0], -1).t().float() for w in ws]
                     ).contiguous()


# Tile heights of the step kernel (csrc/mefc_step.cu, 16 warps a block) by
# channel width, the fastest in ``chip_smoke.py --mefc 8 4`` on an H100
# 80GB HBM3 (700 W) at DRSformer's two Subnet shapes on a 512x512 image:
# the tallest tile that fits, one block an SM (th 8 at C = 48 beat th 4
# with two blocks an SM; th 8 does not fit at C = 96). Other widths take
# the tallest tile that fits and still gives every SM a block.
_MEFC_TILE_ROWS = {48: 8, 96: 4}


def _mefc_smem(c: int, th: int) -> int:
    """Shared memory of one block; more than any card has when no build of
    the kernel takes ``c`` and ``th``."""
    from image_restoration_tpu_torch.kernels.build import load_library

    return load_library().lib.ir_mefc_step_smem(c, th)


def _mefc_tile_rows(b, h, w, c, device) -> int:
    """``_MEFC_TILE_ROWS``'s if it fits the card, else the tallest of
    8/4/2/1 rows that fits and gives every SM a block."""
    return _pick_tile_rows(_MEFC_TILE_ROWS.get(c), lambda t: _mefc_smem(c, t),
                           lambda t: _tiles(b, h, w, t), device)


def _pack_step(sp: StepParams):
    """The step's weights as the kernel takes them: the four W1 (4, C, C)
    bf16, (in, out); the SepConvs' first and second taps and the DilConvs'
    taps, fp32 (sum k^2, C)."""
    w1 = torch.stack([_io(wt) for wt in sp.sep_w1]).to(torch.bfloat16)
    return (w1.contiguous(), _taps(sp.sep_dwa), _taps(sp.sep_dwb),
            _taps(sp.dil_dw))


def mefc_step(x, sp: StepParams, m):
    """One op-mixture step: relu(relu(sum_op op(x) @ M_op) + x), (B, H, W, C)
    in x's dtype.

    x: (B, H, W, C) bf16 on the GPU, C a multiple of 16 up to 128, any H and
    W; m: (B, 8, C, C) bf16 from :func:`fold_step`.
    """
    if x.device.type == "cpu":
        return mefc_step_ref(x, sp, m)
    from image_restoration_tpu_torch.kernels.build import load_library

    _check_input("x", x, x)
    _check_input("m", m, x)
    b, h, w, c = x.shape
    if c % 16 or m.shape != (b, NUM_OPS, c, c):
        raise ValueError(f"mefc_step: x {tuple(x.shape)}, m {tuple(m.shape)};"
                         f" C must be a multiple of 16")
    if x.data_ptr() % 16 or m.data_ptr() % 16:
        raise ValueError("x and m must start on a 16-byte boundary (the "
                         "kernel copies 16 bytes at a time)")
    for t in (*sp.sep_dwa, *sp.sep_w1, *sp.sep_dwb, *sp.dil_dw):
        if t.device != x.device:
            raise ValueError(f"a step parameter is on {t.device}, the input "
                             f"on {x.device}")
    lib = load_library()
    th = _mefc_tile_rows(b, h, w, c, x.device)
    w1, dwa, dwb, dwd = _pack_step(sp)

    def launch():
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = lib.lib.ir_mefc_step(
                x.data_ptr(), w1.data_ptr(), dwa.data_ptr(),
                dwb.data_ptr(), dwd.data_ptr(), m.data_ptr(), out.data_ptr(),
                b, h, w, c, th, stream)
        lib.check(code, "mefc_step")
        mefc_step.launches += 1
        return out

    return forward_only("mefc_step", (x, m, *sp), launch)


mefc_step.launches = 0


def fused_mefc_steps(x, steps: List[StepParams], weights):
    """The Subnet's op-mixture steps on (B, H, W, C): per step, the fold and
    one :func:`mefc_step`. ``weights`` (B, steps, 8) in x's dtype."""
    for st, sp in enumerate(steps):
        x = mefc_step(x, sp, fold_step(sp, weights[:, st], x.dtype))
    return x
