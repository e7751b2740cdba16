"""LN1 + qkv 1x1 + 3x3 depthwise: the first kernel of the three-kernel
Restormer block.

Port of image_restoration_tpu/kernels/mdta_pallas.py. :func:`ln_qkv_dwconv`
(CUDA ``csrc/ln_qkv_dwconv.cu``, K4) computes dwconv3(qkv1x1(LN1(x))) in
one pass over x and writes the (B, H, W, 3C) qkv map, channels
``[q | k | v]`` contiguous: the JAX split variant's 128-lane slots are a
TPU layout. :mod:`kernels.attn_core` reads the map.

On a CUDA tensor the wrapper launches the kernel, or raises if the kernel
cannot take the input; on a CPU tensor it runs :func:`ln_qkv_dwconv_ref`,
which rounds where the kernel rounds (the LN output and the 1x1 weights to
x's dtype, the product and the taps in fp32, only the result rounded) and
does not round at all in fp32. The wrapper counts its launches in
``.launches``. Forward only: on CUDA
tensors that require grad ``backward()`` raises
(``kernels/forward_only.py``).
"""

from __future__ import annotations

import torch

from image_restoration_tpu_torch.kernels.block import (
    FrontParams,
    _check_input,
    _check_params,
    _pick_tile_rows,
    _ptr,
    _tiles,
    front_qkv_f32,
    front_weights,
)
from image_restoration_tpu_torch.kernels.forward_only import forward_only

# Tile heights (output rows per block) and warps per block of K4 by channel
# width, the fastest in ``chip_smoke.py --front 8 4 2 1 --warps 8|16`` on an
# H100 80GB HBM3 (700 W); csrc/front.cuh is built for 8 and 16 warps. K4
# keeps no Gram, so it takes taller tiles than K1 where K1's do not fit.
_QKV_TILE_ROWS = {48: 8, 96: 8, 192: 8, 384: 2}
_QKV_WARPS = {48: 8, 96: 8, 192: 16, 384: 8}


def _qkv_warps(c: int) -> int:
    return _QKV_WARPS.get(c, 8)


def ln_qkv_dwconv_ref(x, p: FrontParams, eps: float = 1e-5):
    """Plain version of :func:`ln_qkv_dwconv`: (B, H, W, 3C) in x's dtype."""
    return front_qkv_f32(x, p, eps).to(x.dtype).contiguous()


def ln_qkv_dwconv(x, p: FrontParams, eps: float = 1e-5):
    """dwconv3(qkv1x1(LN1(x))) + biases, (B, H, W, 3C), channels
    [q | k | v].

    x: (B, H, W, C) bf16 on the GPU, C a multiple of 16.
    p: FrontParams (``BlockParams.front()``).
    """
    if x.device.type == "cpu":
        return ln_qkv_dwconv_ref(x, p, eps)
    from image_restoration_tpu_torch.kernels.build import load_library

    _check_input("x", x, x)
    b, h, w, c = x.shape
    if c % 16:
        raise ValueError(f"ln_qkv_dwconv needs C a multiple of 16, got {c}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel "
                         "copies 16 bytes at a time)")
    _check_params(p, x)
    lib = load_library()
    warps = _qkv_warps(c)
    th = _pick_tile_rows(_QKV_TILE_ROWS.get(c),
                         lambda t: lib.lib.ir_ln_qkv_dwconv_smem(c, t, warps),
                         lambda t: _tiles(b, h, w, t), x.device)
    wqkv, dw, ln_w, ln_b, bqkv, db = front_weights(p, c)

    def launch():
        out = torch.empty((b, h, w, 3 * c), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = lib.lib.ir_ln_qkv_dwconv(
                x.data_ptr(), ln_w.data_ptr(), _ptr(ln_b), wqkv.data_ptr(),
                _ptr(bqkv), dw.data_ptr(), _ptr(db), out.data_ptr(), b, h, w, c,
                th, warps, float(eps), stream)
        lib.check(code, "ln_qkv_dwconv")
        ln_qkv_dwconv.launches += 1
        return out

    return forward_only("ln_qkv_dwconv", (x, *p), launch)


ln_qkv_dwconv.launches = 0
