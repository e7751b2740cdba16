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

Both kernels are persistent: about as many blocks as the card holds at once
(measured once per shape by the occupancy API and cached) walk the pixel
tiles, loading the next tile while the current one runs. Their launch
configurations come from per-width tables (``_ACC_*``, ``_APPLY_*``),
chosen by ``chip_smoke.py --attn`` sweeps. K5 gives each block one head
and sums its blocks' partials in a fixed order (two runs give the same
bits). K6 reads W_proj as the parameter holds it, (out, in) fp32, and
rounds it to bf16 as each block stages it, so :func:`attn_apply` packs no
weights on a launch.

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


# Launch tables by channel width, chosen by ``chip_smoke.py --attn`` sweeps
# on an H100 80GB HBM3 (700 W). K5 (csrc/attn_core.cu: one head a block,
# the warps that cover its Gram times pixel shares, 8 at most): pixels a
# tile, tile slots (2 or 3: loads one or two tiles ahead) and the fewest
# tiles a block walks, so that at the small deep-level maps a block's
# partial (ch^2 + 2 ch floats) does not outweigh its tiles. K6: pixels a
# tile, warps a block, output columns a warp job and column groups (blocks
# that split a tile's output columns, so that each stages only its rows of
# W_proj: C = 384's whole W_proj does not fit).
_ACC_PIXELS = {48: 128, 96: 64, 192: 64, 384: 64}
_ACC_RING = {48: 2, 96: 2, 192: 2, 384: 3}
_ACC_WALK = {48: 1, 96: 1, 192: 4, 384: 2}
_APPLY_PIXELS = {48: 128, 96: 64, 192: 64, 384: 32}
_APPLY_WARPS = {48: 8, 96: 8, 192: 8, 384: 4}
_APPLY_COLS = {48: 48, 96: 48, 192: 96, 384: 48}
_APPLY_GROUPS = {48: 1, 96: 1, 192: 1, 384: 4}


def _acc_config(c):
    """K5's (pixels a tile, slots) at width ``c``; 64 and 2 where the
    tables have no entry."""
    return _ACC_PIXELS.get(c, 64), _ACC_RING.get(c, 2)


def _apply_config(c):
    """K6's (pixels, warps, columns a warp, column groups) at width ``c``;
    64 pixels, 8 warps, 16 columns and one group where the tables have no
    entry."""
    return (_APPLY_PIXELS.get(c, 64), _APPLY_WARPS.get(c, 8),
            _APPLY_COLS.get(c, 16), _APPLY_GROUPS.get(c, 1))


def _apply_weights(proj_w, proj_b):
    """What :func:`attn_apply` hands the kernel for W_proj and b_proj: the
    parameters themselves when they are fp32 and contiguous (the kernel
    rounds W_proj to bf16 as it stages it), else fp32 copies."""
    return _f32(proj_w), _f32(proj_b)


_GRIDS = {}


def _grid(lib, kind, device, args, tiles, per_item, walk=1):
    """Blocks per batch image of a persistent launch: ``per_item`` blocks
    (heads or column groups) times the tile strides the card holds at once
    (SMs x blocks an SM), no more than the tiles / ``walk``; cached per
    shape."""
    key = (kind, device, args, tiles, walk)
    if key not in _GRIDS:
        with torch.cuda.device(device):
            per_sm = getattr(lib.lib, f"ir_attn_{kind}_blocks")(*args)
            sms = torch.cuda.get_device_properties(device).multi_processor_count
        if per_sm < 1:
            raise ValueError(f"attn_{kind}: (C, heads, config) {args} is not "
                             f"built or does not fit the card")
        strides = min(max(1, tiles // walk), max(1, per_sm * sms // per_item))
        _GRIDS[key] = per_item * strides
    return _GRIDS[key]


def attn_acc(qkv, num_heads: int):
    """Pass A: (gram, ss) as :func:`attn_acc_ref` documents.

    qkv: (B, H, W, 3C) bf16 on the GPU from :func:`kernels.mdta.ln_qkv_dwconv`.
    """
    if qkv.device.type == "cpu":
        return attn_acc_ref(qkv, num_heads)
    from image_restoration_tpu_torch.kernels.build import load_library

    b, h, w, c, ch = _check_qkv(qkv, num_heads)
    lib = load_library()
    cfg = _acc_config(c)
    pix = cfg[0]
    grid_x = _grid(lib, "acc", qkv.device, (c, num_heads, *cfg),
                   -(-h * w // pix), num_heads, _ACC_WALK.get(c, 1))
    strides = grid_x // num_heads
    n_gram, n_ss = num_heads * ch * ch, 2 * c

    def launch():
        # one buffer: the partials, then the Gram and the sums of squares
        buf = torch.empty(b * (strides + 1) * (n_gram + n_ss),
                          device=qkv.device, dtype=torch.float32)
        gram_part, ss_part, gram, ss = buf.split(
            [b * strides * n_gram, b * strides * n_ss, b * n_gram, b * n_ss])
        with torch.cuda.device(qkv.device):
            stream = torch.cuda.current_stream(qkv.device).cuda_stream
            code = lib.lib.ir_attn_acc(
                qkv.data_ptr(), gram_part.data_ptr(), ss_part.data_ptr(),
                gram.data_ptr(), ss.data_ptr(), b, h * w, c, num_heads, *cfg,
                grid_x, stream)
        lib.check(code, "attn_acc")
        attn_acc.launches += 1
        return gram.view(b, num_heads, ch, ch), ss.view(b, 2, c)

    return forward_only("attn_acc", (qkv,), launch)


attn_acc.launches = 0


def attn_apply(qkv, x, at, proj_w, proj_b):
    """Pass B: x + bf16(v @ A^T) @ W_proj + b_proj, (B, H, W, C) in x's
    dtype.

    qkv: (B, H, W, 3C) and x: (B, H, W, C) bf16 on the GPU; at:
    (B, heads, ch, ch) bf16 from :func:`finalize_at`; proj_w (C, C, 1, 1)
    and proj_b (C) or None in torch layout. The kernel reads proj_w (fp32,
    (out, in)) and proj_b as they are and rounds W_proj to bf16 as it
    stages it: nothing is packed on a launch.
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
    cfg = _apply_config(c)
    pix, groups = cfg[0], cfg[3]
    grid_x = _grid(lib, "apply", x.device, (c, heads, *cfg),
                   -(-h * w // pix), groups)
    wp, bp = _apply_weights(proj_w, proj_b)
    if wp.data_ptr() % 16:
        raise ValueError("proj_w must start on a 16-byte boundary")

    def launch():
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = lib.lib.ir_attn_apply(
                qkv.data_ptr(), x.data_ptr(), at.data_ptr(), wp.data_ptr(),
                _ptr(bp), out.data_ptr(), b, h * w, c, heads, *cfg, grid_x,
                stream)
        lib.check(code, "attn_apply")
        attn_apply.launches += 1
        return out

    return forward_only("attn_apply", (qkv, x, at, proj_w, proj_b), launch)


attn_apply.launches = 0
