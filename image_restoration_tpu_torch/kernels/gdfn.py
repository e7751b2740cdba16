"""LN2 + GDFN + residual: the last kernel of the three-kernel Restormer
block.

Port of image_restoration_tpu/kernels/gdfn_pallas.py. :func:`fused_ln_gdfn`
(CUDA ``csrc/ln_gdfn.cu``, K3) computes x + GDFN(LN2(x)) in one pass over
x: LN2 (fp32 statistics) -> bf16 -> the [content | gate] 1x1 (fp32
accumulation) + bias -> the fp32 3x3 depthwise + bias -> gelu(content) *
gate -> bf16 -> the 1x1 out + bias + x. It is the tail of the whole-block
pair's pass 2 (``kernels/block.py``) with the attention output replaced by
x, and shares its device code and weight packing.

On a CUDA tensor the wrapper launches the kernel, or raises if the kernel
cannot take the input; on a CPU tensor it runs :func:`ln_gdfn_ref`, which
rounds where the kernel rounds when given bf16 and does not round at all in
fp32. The wrapper counts its launches in ``.launches``.

:func:`fused_ln_gdfn` differentiates as the JAX ``fused_ln_gdfn`` custom
VJP does (``gdfn_pallas.py:261-283``): the forward launches K3 and keeps
only x and the parameters; the backward recomputes ``kernels/block.py``
``reference_ln_gdfn`` (JAX ``_reference_ln_gdfn``) and differentiates
that, launching nothing (:class:`_LnGdfn`).
"""

from __future__ import annotations

import torch

from image_restoration_tpu_torch.kernels.block import (
    _APPLY_TILE_ROWS,
    _apply_warps,
    _HIDDEN_CHUNK,
    GDFNParams,
    RecomputeVJP,
    _check_input,
    _check_params,
    _pick_tile_rows,
    _ptr,
    _tiles,
    gdfn_tail_ref,
    gdfn_weights,
    pad_gdfn_params,
    recompute_vjp,
    reference_ln_gdfn,
    takes_width,
)
from image_restoration_tpu_torch.kernels.build import refuse_export
from image_restoration_tpu_torch.kernels.widths import (
    flat_layout,
    pad_channels,
    unpad_channels,
)


def ln_gdfn_ref(x, p: GDFNParams, eps: float = 1e-5, c_real=None):
    """Plain version of :func:`fused_ln_gdfn`; output in x's dtype."""
    return gdfn_tail_ref(x.float(), p, x.dtype, eps, c_real)


class _LnGdfn(RecomputeVJP):
    """The JAX ``fused_ln_gdfn`` custom VJP: ``_fwd`` keeps (x, params),
    ``_bwd`` is ``jax.vjp`` of ``_reference_ln_gdfn`` at them."""


def fused_ln_gdfn(x, p: GDFNParams, eps: float = 1e-5):
    """x + GDFN(LN2(x)), (B, H, W, C) in x's dtype.

    x: (B, H, W, C) bf16 on the GPU, any C: a C that is not a multiple of
    16 runs padded to the next one (``kernels/widths.py`` ``flat_layout``:
    x, LN2's affine, W_in's columns and W_out's rows padded once, LN2's
    statistics over the real C, the output unpadded once).
    p: GDFNParams (``BlockParams.gdfn()``).

    Differentiable in x and every parameter: the backward is that of
    ``reference_ln_gdfn``, recomputed. Without a gradient to take, this is
    the launch itself.
    """
    return recompute_vjp(
        _LnGdfn, lambda x, *q: _padded(x, GDFNParams(*q), eps),
        lambda x, *q: reference_ln_gdfn(x, GDFNParams(*q), eps), (x, *p))


def _padded(x, p: GDFNParams, eps):
    lay = flat_layout(x.shape[-1])
    out = _fused_ln_gdfn(pad_channels(x, lay), pad_gdfn_params(p, lay), eps,
                         lay.c)
    return unpad_channels(out, lay)


def _fused_ln_gdfn(x, p: GDFNParams, eps, c_real):
    """The raw K3 launch (its plain version on a CPU tensor): C a multiple
    of 16, of which ``c_real`` are real."""
    refuse_export("fused_ln_gdfn (K3)")
    if x.device.type == "cpu":
        return ln_gdfn_ref(x, p, eps, c_real)
    from image_restoration_tpu_torch.kernels.build import load_library

    _check_input("x", x, x)
    b, h, w, c = x.shape
    if not takes_width(c):
        raise ValueError(f"fused_ln_gdfn needs C a multiple of 16, got {c}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel "
                         "copies 16 bytes at a time)")
    hidden = p.out_w.shape[1]
    hp = -(-hidden // _HIDDEN_CHUNK) * _HIDDEN_CHUNK
    _check_params(p, x)
    lib = load_library()
    warps = _apply_warps(c)
    th = _pick_tile_rows(_APPLY_TILE_ROWS.get(c),
                         lambda t: lib.lib.ir_ln_gdfn_smem(c, t, warps),
                         lambda t: _tiles(b, h, w, t), x.device)
    wcg, bcg, dwcg, dbcg, wo, bo, ln_w, ln_b = gdfn_weights(p, c, hp)

    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lib.ir_ln_gdfn(
            x.data_ptr(), ln_w.data_ptr(), _ptr(ln_b), wcg.data_ptr(),
            _ptr(bcg), dwcg.data_ptr(), _ptr(dbcg), wo.data_ptr(), _ptr(bo),
            out.data_ptr(), b, h, w, c, c_real, hp, th, warps, float(eps),
            stream)
    lib.check(code, "fused_ln_gdfn")
    fused_ln_gdfn.launches += 1
    return out


fused_ln_gdfn.launches = 0
