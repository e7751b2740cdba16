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
``.launches``.

:func:`ln_qkv_dwconv` differentiates as the JAX ``fused_ln_qkv_dwconv``
custom VJP does (``mdta_pallas.py:184-205``): the forward launches K4 and
keeps only x and the parameters; the backward recomputes
``kernels/block.py`` ``reference_front`` (JAX ``_reference``) and
differentiates that, launching nothing (:class:`_LnQkvDwconv`).
"""

from __future__ import annotations

import torch

from image_restoration_tpu_torch.kernels.block import (
    FrontParams,
    RecomputeVJP,
    _check_input,
    _check_params,
    _pick_tile_rows,
    _ptr,
    _tiles,
    front_qkv_f32,
    front_weights,
    pad_front_params,
    recompute_vjp,
    reference_front,
    takes_width,
)
from image_restoration_tpu_torch.kernels.build import refuse_export
from image_restoration_tpu_torch.kernels.widths import (
    flat_layout,
    pad_channels,
    unpad_channels,
)

# Tile heights (output rows per block) and warps per block of K4 by channel
# width, the fastest in ``chip_smoke.py --front 8 4 2 1 --warps 8|16`` on an
# H100 80GB HBM3 (700 W); csrc/front.cuh is built for 8 and 16 warps. K4
# keeps no Gram, so it takes taller tiles than K1 where K1's do not fit.
_QKV_TILE_ROWS = {48: 8, 96: 8, 192: 8, 384: 2}
_QKV_WARPS = {48: 8, 96: 8, 192: 16, 384: 8}


def _qkv_warps(c: int) -> int:
    return _QKV_WARPS.get(c, 8)


def ln_qkv_dwconv_ref(x, p: FrontParams, eps: float = 1e-5, c_real=None):
    """Plain version of :func:`ln_qkv_dwconv`: (B, H, W, 3C) in x's dtype."""
    return front_qkv_f32(x, p, eps, c_real).to(x.dtype).contiguous()


class _LnQkvDwconv(RecomputeVJP):
    """The JAX ``fused_ln_qkv_dwconv`` custom VJP: ``_fwd`` keeps (x,
    params), ``_bwd`` is ``jax.vjp`` of ``_reference`` at them."""


def ln_qkv_dwconv(x, p: FrontParams, eps: float = 1e-5):
    """dwconv3(qkv1x1(LN1(x))) + biases, (B, H, W, 3C), channels
    [q | k | v].

    x: (B, H, W, C) bf16 on the GPU, any C: a C that is not a multiple of
    16 runs padded to the next one (``kernels/widths.py`` ``flat_layout``:
    x, LN1's affine and the qkv weights padded once, LN1's statistics over
    the real C, the map unpadded once).
    p: FrontParams (``BlockParams.front()``).

    Differentiable in x and every parameter: the backward is that of
    ``reference_front``, recomputed. Without a gradient to take, this is
    the launch itself.
    """
    return recompute_vjp(
        _LnQkvDwconv, lambda x, *q: _padded(x, FrontParams(*q), eps),
        lambda x, *q: reference_front(x, FrontParams(*q), eps), (x, *p))


def _padded(x, p: FrontParams, eps):
    lay = flat_layout(x.shape[-1])
    out = _ln_qkv_dwconv(pad_channels(x, lay), pad_front_params(p, lay), eps,
                         lay.c)
    return unpad_channels(out, lay, 3)


def _ln_qkv_dwconv(x, p: FrontParams, eps, c_real):
    """The raw K4 launch (its plain version on a CPU tensor): C a multiple
    of 16, of which ``c_real`` are real."""
    refuse_export("ln_qkv_dwconv (K4)")
    if x.device.type == "cpu":
        return ln_qkv_dwconv_ref(x, p, eps, c_real)
    from image_restoration_tpu_torch.kernels.build import load_library

    _check_input("x", x, x)
    b, h, w, c = x.shape
    if not takes_width(c):
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

    out = torch.empty((b, h, w, 3 * c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lib.ir_ln_qkv_dwconv(
            x.data_ptr(), ln_w.data_ptr(), _ptr(ln_b), wqkv.data_ptr(),
            _ptr(bqkv), dw.data_ptr(), _ptr(db), out.data_ptr(), b, h, w, c,
            c_real, th, warps, float(eps), stream)
    lib.check(code, "ln_qkv_dwconv")
    ln_qkv_dwconv.launches += 1
    return out


ln_qkv_dwconv.launches = 0
