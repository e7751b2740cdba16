"""The attention core of the three-kernel Restormer block:
x + project_out(MDTA(qkv)) on the qkv map of :mod:`kernels.mdta`.

Port of image_restoration_tpu/kernels/attn_core_pallas.py, in three steps:

* :func:`attn_acc` (CUDA ``csrc/attn_core.cu``, K5): the per-head q^T k and
  the per-channel sums of squares of q and k over all H*W pixels, fp32, of
  the bf16 q and k;
* :func:`finalize_at` (plain torch, O(C^2)): the norm rescale,
  temperature and per-head softmax, returned as A^T per head. It is not
  folded into W_proj, as the whole-block pair's ``finalize`` folds it: the
  TPU kernel rounds t = v A^T to bf16 before the projection;
* :func:`attn_apply` (CUDA ``csrc/attn_core.cu``, K6):
  out = x + bf16(v @ A^T) @ W_proj + b_proj.

:func:`fused_mdta_core` chains the three. Kernel functions take
(B, H, W, C) contiguous tensors and the (B, H, W, 3C) qkv map, channels
[q | k | v], head-major. On a CUDA tensor a wrapper launches its kernel, or
raises if the kernel cannot take the input; on a CPU tensor it runs its
plain version (``attn_acc_ref``, ``attn_apply_ref``), which rounds where the
kernel rounds when given bf16 and does not round at all in fp32. Each
wrapper counts its launches in ``.launches``. Forward only: on CUDA
tensors that require grad ``backward()`` raises
(``kernels/forward_only.py``).
"""

from __future__ import annotations

import torch

from image_restoration_tpu_torch.kernels.block import (
    _check_input,
    _f32,
    _matmul_1x1,
    _ptr,
    attention_softmax,
)
from image_restoration_tpu_torch.kernels.forward_only import forward_only

_ACC_PIXELS = 128  # csrc/attn_core.cu ACC_PIX: pixels per pass-A tile


def attn_acc_ref(qkv, num_heads: int):
    """Plain version of :func:`attn_acc`: the per-head Gram q^T k
    (B, heads, ch, ch) and the sums of squares of q and k (B, 2, C), fp32,
    of q and k as the map holds them."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    ch = c // num_heads
    q = qkv[..., :c].float().reshape(b, h * w, num_heads, ch)
    k = qkv[..., c:2 * c].float().reshape(b, h * w, num_heads, ch)
    gram = torch.einsum("bnhi,bnhj->bhij", q, k)
    ss = torch.stack([(q * q).sum(1).reshape(b, c),
                      (k * k).sum(1).reshape(b, c)], dim=1)
    return gram, ss


def finalize_at(gram, ss, temperature, dtype):
    """A^T per head, (B, heads, ch, ch) in ``dtype``, from
    :func:`attn_acc`'s Gram and sums of squares."""
    a = attention_softmax(gram, ss, temperature)
    return a.transpose(-1, -2).to(dtype).contiguous()


def attn_apply_ref(qkv, x, at, proj_w, proj_b):
    """Plain version of :func:`attn_apply`; output in x's dtype."""
    dt = x.dtype
    b, h, w, c = x.shape
    heads, ch = at.shape[1], at.shape[2]
    v = qkv[..., 2 * c:].float().reshape(b, h * w, heads, ch)
    t = torch.einsum("bnhk,bhkj->bnhj", v, at.float())
    t = t.reshape(b, h, w, c).to(dt).float()
    return (x.float() + _matmul_1x1(t, proj_w, proj_b, dt)).to(dt)


def fused_mdta_core(qkv, x, temperature, proj_w, proj_b, num_heads: int):
    """x + project_out(MDTA(q, k, v)) on (B, H, W, C) x: :func:`attn_acc`,
    :func:`finalize_at` and :func:`attn_apply`. On CPU tensors this is the
    chain of the plain versions."""
    gram, ss = attn_acc(qkv, num_heads)
    at = finalize_at(gram, ss, temperature, x.dtype)
    return attn_apply(qkv, x, at, proj_w, proj_b)


def _check_qkv(qkv, num_heads):
    _check_input("qkv", qkv, qkv)
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    ch = c // num_heads
    if c3 % 3 or c % 16 or ch % 16 or ch * num_heads != c:
        raise ValueError(f"the attention kernels need a (B, H, W, 3C) map "
                         f"with C and C/heads multiples of 16, got "
                         f"{tuple(qkv.shape)} with {num_heads} heads")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must start on a 16-byte boundary (the kernels "
                         "copy 16 bytes at a time)")
    return b, h, w, c, ch


def attn_acc(qkv, num_heads: int):
    """Pass A: (gram, ss) as :func:`attn_acc_ref` documents.

    qkv: (B, H, W, 3C) bf16 on the GPU from :func:`kernels.mdta.ln_qkv_dwconv`.
    """
    if qkv.device.type == "cpu":
        return attn_acc_ref(qkv, num_heads)
    from image_restoration_tpu_torch.kernels.build import load_library

    b, h, w, c, ch = _check_qkv(qkv, num_heads)
    lib = load_library()
    if lib.lib.ir_attn_acc_smem(c, num_heads) > getattr(
            torch.cuda.get_device_properties(qkv.device),
            "shared_memory_per_block_optin", 232448):
        raise ValueError(f"attn_acc: C={c} too wide for the card's shared "
                         f"memory")
    grid_x = min(-(-h * w // _ACC_PIXELS),
                 2 * torch.cuda.get_device_properties(qkv.device)
                 .multi_processor_count)

    def launch():
        f32 = dict(device=qkv.device, dtype=torch.float32)
        gram_part = torch.empty((b, grid_x, c * ch), **f32)
        ss_part = torch.empty((b, grid_x, 2 * c), **f32)
        gram = torch.empty((b, num_heads, ch, ch), **f32)
        ss = torch.empty((b, 2, c), **f32)
        with torch.cuda.device(qkv.device):
            stream = torch.cuda.current_stream(qkv.device).cuda_stream
            code = lib.lib.ir_attn_acc(
                qkv.data_ptr(), gram_part.data_ptr(), ss_part.data_ptr(),
                gram.data_ptr(), ss.data_ptr(), b, h * w, c, num_heads, grid_x,
                stream)
        lib.check(code, "attn_acc")
        attn_acc.launches += 1
        return gram, ss

    return forward_only("attn_acc", (qkv,), launch)


attn_acc.launches = 0


# Pixels per pass-B block: the most of 128/64/32/16 whose shared memory
# (v or t in bf16 and the fp32 product, csrc/attn_core.cu ApplyAttnSmem)
# stays under 116 KB, so two blocks share an SM.
_APPLY_SMEM_TARGET = 116 * 1024


def attn_apply(qkv, x, at, proj_w, proj_b):
    """Pass B: x + bf16(v @ A^T) @ W_proj + b_proj, (B, H, W, C) in x's
    dtype.

    qkv: (B, H, W, 3C) and x: (B, H, W, C) bf16 on the GPU; at:
    (B, heads, ch, ch) bf16 from :func:`finalize_at`; proj_w (C, C, 1, 1)
    and proj_b (C) or None in torch layout.
    """
    if x.device.type == "cpu":
        return attn_apply_ref(qkv, x, at, proj_w, proj_b)
    from image_restoration_tpu_torch.kernels.build import load_library

    heads = at.shape[1]
    b, h, w, c, ch = _check_qkv(qkv, heads)
    for name, t in (("x", x), ("at", at)):
        _check_input(name, t, qkv)
    if x.shape != (b, h, w, c) or at.shape != (b, heads, ch, ch):
        raise ValueError(f"attn_apply: qkv {tuple(qkv.shape)}, x "
                         f"{tuple(x.shape)}, at {tuple(at.shape)}")
    for name, t in (("proj_w", proj_w), ("proj_b", proj_b)):
        if t is not None and t.device != x.device:
            raise ValueError(f"parameter {name} is on {t.device}, the input "
                             f"on {x.device}")
    lib = load_library()
    npix = next((n for n in (128, 64, 32)
                 if lib.lib.ir_attn_apply_smem(c, n) <= _APPLY_SMEM_TARGET),
                16)
    wp = proj_w.reshape(c, c).t().to(torch.bfloat16).contiguous()
    bp = _f32(proj_b)

    def launch():
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = lib.lib.ir_attn_apply(
                qkv.data_ptr(), x.data_ptr(), at.data_ptr(), wp.data_ptr(),
                _ptr(bp), out.data_ptr(), b, h * w, c, heads, npix, stream)
        lib.check(code, "attn_apply")
        attn_apply.launches += 1
        return out

    return forward_only("attn_apply", (qkv, x, at, proj_w, proj_b), launch)


attn_apply.launches = 0
