"""Whole Restormer TransformerBlock in two passes over the image.

Port of image_restoration_tpu/kernels/block_pallas.py. One block is

* pass 1, :func:`block_front` (CUDA ``csrc/block_front.cu``): LN1, the qkv
  1x1, the 3x3 depthwise; writes v, and reduces the per-head q^T k Gram and
  the per-channel sums of squares of q and k over the image, so q and k
  never reach device memory;
* :func:`finalize` (plain torch, O(C^2)): norm rescale, temperature,
  per-head softmax, and the fold of A^T into W_proj (with CG-IR's
  per-sample output gate folded in as A^T diag(gate) W_proj);
* pass 2, :func:`block_apply_gdfn` (CUDA ``csrc/block_apply_gdfn.cu``):
  x + v @ (A^T W_proj) + b, LN2, the gated-Dconv FFN, and its residual.

Kernel functions take (B, H, W, C) contiguous tensors. The raw launchers
take C and C / heads multiples of 16; :func:`fused_block` takes every
width, running the passes in K1's padded layout (``kernels/widths.py``:
each head padded to a multiple of 16, zero pads, LN statistics over the
real channels, :func:`finalize` at the real width), as the JAX kernels run
on their 128-lane canvas. On a CUDA tensor a
wrapper launches its kernel, or raises if the kernel cannot take the input;
on a CPU tensor it runs its plain version (``block_front_ref``,
``block_apply_gdfn_ref``), which rounds where the kernel rounds when given
bf16 and does not round at all in fp32. Each wrapper counts its launches in
``.launches``.

:func:`fused_block` differentiates as the JAX ``fused_block`` custom VJP
does (``block_pallas.py:634-676``): its forward runs the two passes and
keeps only the block input, the parameters and the gate; its backward
recomputes :func:`reference_block` from them and differentiates that, one
block's plain graph at a time (:class:`RecomputeVJP`, which the other
kernel APIs' VJPs share). Neither package has a backward kernel for it.
:func:`block_front` and :func:`block_apply_gdfn` called alone stay forward
only, as JAX's ``run_front`` has no VJP: on CUDA tensors that require
grad, their ``backward()`` raises (``kernels/forward_only.py``); their
plain versions differentiate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from image_restoration_tpu_torch.kernels.build import refuse_export
from image_restoration_tpu_torch.kernels.forward_only import forward_only
from image_restoration_tpu_torch.kernels.widths import (
    Layout,
    head_layout,
    pad_channels,
    pad_square,
    real_stats,
    round16,
    unpad_channels,
)
from image_restoration_tpu_torch.ops.attention import mdta_attention
from image_restoration_tpu_torch.ops.common import gelu_exact
from image_restoration_tpu_torch.ops.layernorm import layer_norm_f32

Tensor = torch.Tensor


class FrontParams(NamedTuple):
    """The parameters pass 1 reads (torch layout, fp32): LN1, the qkv 1x1
    and the 3x3 depthwise. Restormer's MDTA and DRSformer's TKSA share
    them, so both blocks run the same pass 1."""

    ln1_w: Tensor
    ln1_b: Optional[Tensor]
    qkv_w: Tensor              # (3C, C, 1, 1), output channels [q | k | v]
    qkv_b: Optional[Tensor]
    dw_w: Tensor               # (3C, 1, 3, 3)
    dw_b: Optional[Tensor]


class GDFNParams(NamedTuple):
    """The parameters of LN2 + GDFN (torch layout, fp32), which K2's tail
    and the three-kernel block's ``kernels/gdfn.py`` read."""

    ln_w: Tensor
    ln_b: Optional[Tensor]
    in_w: Tensor               # (2 hidden, C, 1, 1), [content | gate]
    in_b: Optional[Tensor]
    dw_w: Tensor               # (2 hidden, 1, 3, 3)
    dw_b: Optional[Tensor]
    out_w: Tensor              # (C, hidden, 1, 1)
    out_b: Optional[Tensor]


class BlockParams(NamedTuple):
    """One TransformerBlock's parameters in torch layout (fp32).

    LN biases are None for the BiasFree norm; conv biases are None for the
    bias-free convs of Restormer-base."""

    ln1_w: Tensor
    ln1_b: Optional[Tensor]
    qkv_w: Tensor              # (3C, C, 1, 1), output channels [q | k | v]
    qkv_b: Optional[Tensor]
    dw_w: Tensor               # (3C, 1, 3, 3)
    dw_b: Optional[Tensor]
    temperature: Tensor        # (heads, 1, 1), or per sample (B, heads)
    proj_w: Tensor             # (C, C, 1, 1)
    proj_b: Optional[Tensor]
    ln2_w: Tensor
    ln2_b: Optional[Tensor]
    in_w: Tensor               # (2 hidden, C, 1, 1), [content | gate]
    in_b: Optional[Tensor]
    dw2_w: Tensor              # (2 hidden, 1, 3, 3)
    dw2_b: Optional[Tensor]
    out_w: Tensor              # (C, hidden, 1, 1)
    out_b: Optional[Tensor]

    def front(self) -> FrontParams:
        return FrontParams(*self[:len(FrontParams._fields)])

    def gdfn(self) -> GDFNParams:
        return GDFNParams(*self[-len(GDFNParams._fields):])


# ------------------------------------------------------------ plain parts ---

def _f32(t):
    """fp32 contiguous copy of an optional parameter (None stays None)."""
    return None if t is None else t.float().contiguous()


def _matmul_1x1(y, w, b, dt):
    """y (.., Cin) fp32 holding dt values; w (Cout, Cin, 1, 1) rounded to dt;
    fp32 product (exact widening of dt operands, fp32 accumulation)."""
    out = y @ w.reshape(w.shape[0], -1).t().to(dt).float()
    return out if b is None else out + b.float()


def _dwconv3(t, w, b):
    """Zero-padded 3x3 depthwise conv of a (B, H, W, N) fp32 tensor."""
    y = F.conv2d(t.permute(0, 3, 1, 2), w.float(), _f32(b), padding=1,
                 groups=t.shape[-1])
    return y.permute(0, 2, 3, 1)


def front_qkv_f32(x, p: FrontParams, eps: float = 1e-5, c_real=None):
    """dwconv3(qkv1x1(LN1(x))) in fp32, (B, H, W, 3C), rounded where the
    kernels round before it: the LN output and the 1x1 weights to x's
    dtype; the product and the taps in fp32. ``c_real``: LN1's statistics
    over the real channels of a padded x (``kernels/widths.py``)."""
    dt = x.dtype
    y = layer_norm_f32(x, p.ln1_w, p.ln1_b, eps, c_real)
    proj = _matmul_1x1(y.to(dt).float(), p.qkv_w, p.qkv_b, dt)
    return _dwconv3(proj, p.dw_w, p.dw_b)


def block_front_ref(x, p: FrontParams, num_heads: int, eps: float = 1e-5,
                    c_real=None):
    """Plain version of :func:`block_front`.

    Returns v (B, H, W, C) in x's dtype, the per-head Gram q^T k
    (B, heads, ch, ch) fp32 of q and k rounded to x's dtype, and the fp32
    sums of squares of q and k over all pixels (B, 2, C).
    """
    dt = x.dtype
    b, h, w, c = x.shape
    q, k, v = front_qkv_f32(x, p, eps, c_real).split(c, dim=-1)
    ch = c // num_heads
    qh = q.to(dt).float().reshape(b, h * w, num_heads, ch)
    kh = k.to(dt).float().reshape(b, h * w, num_heads, ch)
    gram = torch.einsum("bnhi,bnhj->bhij", qh, kh)
    ss = torch.stack([(q * q).sum((1, 2)), (k * k).sum((1, 2))], dim=1)
    return v.to(dt).contiguous(), gram, ss


def attention_softmax(gram, ss, temperature):
    """The per-head attention A (B, heads, ch, ch) fp32 from the Gram and
    the sums of squares: logits are the Gram rescaled by the q and k norms
    (normalization commutes with the contraction), times the temperature,
    per head (heads, 1, 1) or per sample and head (B, heads); A is their
    softmax over the last axis."""
    b, heads, ch, _ = gram.shape
    qn = torch.sqrt(ss[:, 0]).clamp_min(1e-12).reshape(b, heads, ch)
    kn = torch.sqrt(ss[:, 1]).clamp_min(1e-12).reshape(b, heads, ch)
    logits = gram / (qn[..., :, None] * kn[..., None, :])
    logits = logits * temperature.reshape(-1, heads, 1, 1).float()
    return torch.softmax(logits, dim=-1)


def finalize(gram, ss, temperature, proj_w, dtype, gate=None):
    """A^T W_proj per batch, (B, C, C) in ``dtype``.

    A (:func:`attention_softmax`) is block-diagonal over heads, so A^T
    W_proj is computed head by head. W_proj is rounded to ``dtype`` first,
    as the TPU kernel packs it. ``gate`` (B, C), CG-IR's per-channel output
    gate on the attention output before project_out, folds in as A^T
    diag(gate) W_proj, in fp32 before the product and rounded after it
    (``block_pallas.py:587-598``): (gate * (A v)) W = v (A^T diag(gate) W).
    """
    b, heads, ch, _ = gram.shape
    c = heads * ch
    at = attention_softmax(gram, ss, temperature).transpose(-1, -2)
    if gate is not None:
        at = at * gate.float().reshape(b, heads, 1, ch)
    wp = proj_w.reshape(c, c).t().to(dtype).float().reshape(heads, ch, c)
    return torch.matmul(at, wp).reshape(b, c, c).to(dtype)


def gdfn_tail_ref(ao, p: GDFNParams, dt, eps: float = 1e-5, c_real=None):
    """ao + GDFN(LN2(ao)) on fp32 ``ao``, rounded where K2 and K3 round:
    the LN output, the 1x1 weights and gelu * gate to ``dt``; content and
    gate stay fp32 between the 1x1 and the depthwise. Output in ``dt``.
    ``c_real``: LN2's statistics over the real channels of a padded ao."""
    y = layer_norm_f32(ao, p.ln_w, p.ln_b, eps, c_real)
    cg = _matmul_1x1(y.to(dt).float(), p.in_w, p.in_b, dt)
    cont, gate = _dwconv3(cg, p.dw_w, p.dw_b).chunk(2, dim=-1)
    act = (gelu_exact(cont) * gate).to(dt).float()
    return (_matmul_1x1(act, p.out_w, p.out_b, dt) + ao).to(dt)


def block_apply_gdfn_ref(v, x, atw, p: BlockParams, eps: float = 1e-5,
                         c_real=None):
    """Plain version of :func:`block_apply_gdfn`; output in x's dtype."""
    b, h, w, c = x.shape
    ao = torch.bmm(v.float().reshape(b, h * w, c), atw.float())
    ao = ao.reshape(b, h, w, c) + x.float()
    if p.proj_b is not None:
        ao = ao + p.proj_b.float()
    return gdfn_tail_ref(ao, p.gdfn(), x.dtype, eps, c_real)


def _conv_dt(t, wt, bias, dt, groups=1, padding=0):
    """Zero-padded conv of a (B, H, W, N) tensor with its weights and bias
    rounded to ``dt`` (the JAX references' ``conv_general_dilated`` in the
    compute dtype)."""
    bias = None if bias is None else bias.to(dt)
    out = F.conv2d(t.permute(0, 3, 1, 2), wt.to(dt), bias, padding=padding,
                   groups=groups)
    return out.permute(0, 2, 3, 1)


def reference_front(x, p: FrontParams, eps: float = 1e-5):
    """dwconv3(qkv1x1(LN1(x))), (B, H, W, 3C), as the plain composition of
    its ops: counterpart of the JAX ``mdta_pallas._reference``, which the
    ``fused_ln_qkv_dwconv`` VJP differentiates. The LN output and both convs
    in x's dtype, LN statistics in fp32."""
    dt = x.dtype
    y = layer_norm_f32(x, p.ln1_w, p.ln1_b, eps).to(dt)
    qkv = _conv_dt(y, p.qkv_w, p.qkv_b, dt)
    return _conv_dt(qkv, p.dw_w, p.dw_b, dt, groups=qkv.shape[-1], padding=1)


def reference_core(qkv, x, temperature, proj_w, proj_b, num_heads: int,
                   gate=None):
    """x + project_out(MDTA(q, k, v)) on the (B, H, W, 3C) map, as the plain
    composition of its ops: counterpart of the JAX
    ``attn_core_pallas._reference_core``. ``gate`` (B, C) multiplies the
    attention output, rounded to x's dtype, before project_out."""
    dt = x.dtype
    q, k, v = (t.permute(0, 3, 1, 2) for t in qkv.chunk(3, dim=-1))
    attn = mdta_attention(q, k, v, temperature, num_heads)
    if gate is not None:
        attn = attn * gate.to(dt)[:, :, None, None]
    return x + _conv_dt(attn.permute(0, 2, 3, 1), proj_w, proj_b, dt)


def reference_ln_gdfn(x, p: GDFNParams, eps: float = 1e-5):
    """x + GDFN(LN2(x)) as the plain composition of its ops: counterpart of
    the JAX ``gdfn_pallas._reference_ln_gdfn``. Every conv in x's dtype,
    the LN statistics and gelu in fp32."""
    dt = x.dtype
    hid = _conv_dt(layer_norm_f32(x, p.ln_w, p.ln_b, eps).to(dt), p.in_w,
                   p.in_b, dt)
    hid = _conv_dt(hid, p.dw_w, p.dw_b, dt, groups=hid.shape[-1], padding=1)
    cont, gate = hid.chunk(2, dim=-1)
    act = gelu_exact(cont.float()).to(dt) * gate
    return x + _conv_dt(act, p.out_w, p.out_b, dt)


def reference_block(x, p: BlockParams, num_heads: int, eps: float = 1e-5,
                    gate=None):
    """The block as the plain composition of its ops, on (B, H, W, C):
    counterpart of the JAX ``block_pallas._reference_block``. Every conv runs
    in x's dtype; LN statistics, norms and softmax in fp32. ``gate`` (B, C)
    multiplies the attention output, rounded to x's dtype, before
    project_out (the JAX ``attn_core_pallas._reference_core``)."""
    qkv = reference_front(x, p.front(), eps)
    x = reference_core(qkv, x, p.temperature, p.proj_w, p.proj_b, num_heads,
                       gate)
    return reference_ln_gdfn(x, p.gdfn(), eps)


# ------------------------------------------------------- differentiable ---

class RecomputeVJP(torch.autograd.Function):
    """A kernel API with the semantics of its JAX custom VJP: the forward
    runs ``launch`` on the inputs and saves only them (the residuals of
    JAX's ``_fwd``: the input and the parameters, no intermediate map); the
    backward differentiates ``reference``, the plain composition JAX's
    ``_bwd`` differentiates, recomputed from them on detached leaves, and
    launches no kernel. A training step so holds one call's plain graph at
    a time, during its backward. Each kernel API subclasses it, which names
    its nodes in the graph (``_FusedBlockBackward``)."""

    @staticmethod
    def forward(ctx, launch, reference, *inputs):
        ctx.reference = reference
        ctx.save_for_backward(*inputs)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.reference(*leaves)
            wanted = [t for t, n in zip(leaves, needs) if t is not None and n]
            grads = iter(torch.autograd.grad(out, wanted, g,
                                             allow_unused=True))
        return (None, None, *(next(grads) if t is not None and n else None
                              for t, n in zip(leaves, needs)))


def recompute_vjp(fn, launch, reference, inputs):
    """``launch(*inputs)``, differentiable in every tensor of ``inputs``
    (None allowed) through ``fn``, a :class:`RecomputeVJP` subclass. With
    nothing to differentiate (no input requires grad, or grad mode is off)
    this is ``launch(*inputs)`` itself."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return fn.apply(launch, reference, *inputs)
    return launch(*inputs)


# ---------------------------------------------------------------- kernels ---

_HIDDEN_CHUNK = 32  # csrc/gdfn.cuh NH: hidden padded to this


def _ptr(t):
    return None if t is None else t.data_ptr()


def takes_width(c: int) -> bool:
    """The channel widths the raw launchers of K1-K4 and K7 take: multiples
    of 16 (the 16-wide fragments of their products). The kernel APIs take
    every width, padded (``kernels/widths.py``)."""
    return c > 0 and c % 16 == 0


def front_takes(c: int, heads: int) -> bool:
    """The (C, heads) the raw launcher :func:`block_front` (K1) takes: C
    and the head width C / heads multiples of 16."""
    return (heads > 0 and c % heads == 0 and takes_width(c)
            and takes_width(c // heads))


def front_layout(c: int, heads: int) -> Layout:
    """K1's padded layout for C channels in ``heads`` heads, which the pair
    and DRSformer's front run in: each head padded to a multiple of 16 (the
    identity where :func:`front_takes`)."""
    return head_layout(c, heads, round16(c // heads))


# Gram fragments a warp of K1 keeps, by block size (csrc/front.cuh
# front_frags: 16 warps leave a thread too few registers above 3).
_FRONT_MAX_FRAGS = {8: 9, 16: 3}


def front_gram_fits(c: int, heads: int) -> bool:
    """Whether K1 holds the per-head Gram of C channels in ``heads`` heads
    once padded (:func:`front_layout`): heads x (padded head width / 16)^2
    16 x 16 fragments over the block's warps, at most 9 a warp with 8
    warps and 3 with 16 (``csrc/front.cuh`` ``front_frags``)."""
    lay = front_layout(c, heads)
    warps = _front_warps(lay.cp)
    units = heads * (lay.chp // 16) ** 2
    return -(-units // warps) <= _FRONT_MAX_FRAGS[warps]


def block_misfits(c: int, heads: int, fused_block: bool = False,
                  fused_attn: bool = False) -> dict:
    """{flag: why} for each kernel flag that is on for a block of C
    channels in ``heads`` heads that its kernels cannot run, padded as the
    kernel APIs pad (``kernels/widths.py``): the pair when K1 cannot hold
    the padded per-head Gram (:func:`front_gram_fits`), the three-kernel
    attention when a head is wider than K5 and K6 are built for (128).
    Padding takes every other width. A block whose padded tile does not fit
    the card's shared memory raises at its launch (``_pick_tile_rows``);
    that limit is the card's and shows only there."""
    from image_restoration_tpu_torch.kernels.attn_core import HEAD_WIDTHS

    shape = f"a block has C {c} in {heads} heads of {c / heads:g}"
    why = {}
    if fused_block and not front_gram_fits(c, heads):
        why["fused_block"] = (f"{shape} (K1 keeps heads x (padded head "
                              f"width / 16)^2 16x16 Gram fragments over its "
                              f"warps, at most 9 a warp with 8 warps, 3 "
                              f"with 16)")
    if fused_attn and c // heads > HEAD_WIDTHS[-1]:
        why["fused_attn"] = (f"{shape} (K5 and K6 take heads up to "
                             f"{HEAD_WIDTHS[-1]} wide)")
    return why


def _check_input(name, t, like):
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernels run on CUDA, "
                         f"the plain versions on the CPU")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (B, H, W, C)")


def _check_params(p: BlockParams, x):
    for name, t in zip(p._fields, p):
        if t is not None and t.device != x.device:
            raise ValueError(f"parameter {name} is on {t.device}, the input "
                             f"on {x.device}")


# Tile heights (output rows per block) by channel width, the fastest in a
# sweep on an H100 80GB HBM3 (700 W) at the block shapes of Restormer-base
# on a 512x512 image (8/4/2 rows x 8/16 warps for K2 and K3,
# ``chip_smoke.py --tail 8 4 2 --warps N``); the slowest choice ran up to
# 2x longer. The entries for C 32, 64, 128 and 256 are the fastest at
# MEASNet's block shapes (``chip_smoke.py --tail 8 4 2 1 --warps 8|16
# --shapes measnet``, NVIDIA H100 80GB HBM3, 700.00 W; K2 alone, summed
# over the forward's calls of each width). Other widths, or a card with
# less shared memory, take the rule of ``_pick_tile_rows``.
_APPLY_TILE_ROWS = {32: 4, 48: 8, 64: 8, 96: 4, 128: 8, 192: 8, 256: 2,
                    384: 2}
# Warps per block of K2 and K3 (csrc/gdfn.cuh is built for 8 and 16), from
# the same sweeps: 16 warps win where a tile's products are long (C >= 128),
# 8 where more blocks share an SM.
_APPLY_WARPS = {32: 8, 48: 8, 64: 8, 96: 8, 128: 16, 192: 16, 256: 16,
                384: 16}
# Tile heights and warps of K1 (csrc/front.cuh, built for 8 and 16 warps),
# the fastest in ``chip_smoke.py --front 8 4 2 1 --warps 8|16`` on the same
# card (C 32-256: ``--shapes measnet``, NVIDIA H100 80GB HBM3, 700.00 W);
# K4 has its own (kernels/mdta.py). At C = 384 only 8 warps hold the Gram
# and only th <= 2 fits; at 192, th = 8 does not fit, nor at 256.
_FRONT_TILE_ROWS = {32: 8, 48: 8, 64: 8, 96: 8, 128: 8, 192: 4, 256: 2,
                    384: 2}
_FRONT_WARPS = {32: 8, 48: 8, 64: 8, 96: 16, 128: 16, 192: 16, 256: 16,
                384: 8}


def _apply_warps(c: int) -> int:
    return _APPLY_WARPS.get(c, 16 if c >= 192 else 8)


def _front_warps(c: int) -> int:
    return _FRONT_WARPS.get(c, 8)


def _pick_tile_rows(preferred, smem_of, tiles_of, device) -> int:
    """``preferred`` if its shared memory fits the card; else the tallest
    tile (8, 4, 2 or 1 rows) that fits and still gives every SM a block;
    else the smallest tile that fits."""
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    if preferred is not None and smem_of(preferred) <= limit:
        return preferred
    fitting = [th for th in (8, 4, 2, 1) if smem_of(th) <= limit]
    if not fitting:
        raise ValueError("block too wide for the card's shared memory")
    for th in fitting:
        if tiles_of(th) >= props.multi_processor_count:
            return th
    return fitting[-1]


def _tiles(b, h, w, th):
    return b * -(-h // th) * -(-w // 16)


def front_weights(p: FrontParams, c: int):
    """The front's weights as the CUDA kernels take them: W_qkv (C, 3C)
    bf16, the taps (9, 3C) fp32, LN1's affine and the biases fp32."""
    wqkv = p.qkv_w.reshape(3 * c, c).t().to(torch.bfloat16).contiguous()
    dw = p.dw_w.reshape(3 * c, 9).t().float().contiguous()
    return (wqkv, dw, _f32(p.ln1_w), _f32(p.ln1_b), _f32(p.qkv_b),
            _f32(p.dw_b))


_FRONT_BLOCKS = {}


def _front_blocks(lib, device, c, heads, th, warps) -> int:
    """Blocks of pass 1 the card holds at once: its SMs times the blocks
    one SM holds (by shared memory and registers), cached per shape."""
    key = (device, c, heads, th, warps)
    if key not in _FRONT_BLOCKS:
        with torch.cuda.device(device):
            per_sm = lib.lib.ir_block_front_blocks(c, heads, th, warps)
        _FRONT_BLOCKS[key] = max(per_sm, 1) * torch.cuda.get_device_properties(
            device).multi_processor_count
    return _FRONT_BLOCKS[key]


def block_front(x, p: FrontParams, num_heads: int, eps: float = 1e-5,
                c_real=None):
    """Pass 1: (v, gram, ss) as :func:`block_front_ref` documents.

    x: (B, H, W, C) bf16 on the GPU, C and C / num_heads multiples of 16.
    p: FrontParams (``BlockParams.front()``, ``DRSBlockParams.front()``).
    c_real: the real channels of a padded x (``kernels/widths.py``), which
    LN1's statistics take; None for all C.
    """
    refuse_export("block_front (K1)")
    if x.device.type == "cpu":
        return block_front_ref(x, p, num_heads, eps, c_real)
    from image_restoration_tpu_torch.kernels.build import load_library

    _check_input("x", x, x)
    b, h, w, c = x.shape
    ch = c // num_heads
    if not front_takes(c, num_heads):
        raise ValueError(f"block_front needs C and C/heads multiples of 16, "
                         f"got C={c}, heads={num_heads}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel "
                         "copies 16 bytes at a time)")
    _check_params(p, x)
    lib = load_library()
    warps = _front_warps(c)
    th = _pick_tile_rows(
        _FRONT_TILE_ROWS.get(c),
        lambda t: lib.lib.ir_block_front_smem(c, num_heads, t, warps),
        lambda t: _tiles(b, h, w, t), x.device)
    grid_x = min(-(-h // th) * -(-w // 16),
                 _front_blocks(lib, x.device, c, num_heads, th, warps))
    f32 = dict(device=x.device, dtype=torch.float32)
    wqkv, dw, ln_w, ln_b, bqkv, db = front_weights(p, c)

    def launch():
        v = torch.empty_like(x)
        gram_part = torch.empty((b, grid_x, num_heads * ch * ch), **f32)
        ss_part = torch.empty((b, grid_x, 2 * c), **f32)
        gram = torch.empty((b, num_heads, ch, ch), **f32)
        ss = torch.empty((b, 2, c), **f32)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = lib.lib.ir_block_front(
                x.data_ptr(), ln_w.data_ptr(), _ptr(ln_b), wqkv.data_ptr(),
                _ptr(bqkv), dw.data_ptr(), _ptr(db), v.data_ptr(),
                gram_part.data_ptr(), ss_part.data_ptr(), gram.data_ptr(),
                ss.data_ptr(), b, h, w, c, c_real or c, num_heads, th,
                warps, grid_x, float(eps), stream)
        lib.check(code, "block_front")
        block_front.launches += 1
        return v, gram, ss

    return forward_only("block_front", (x, *p), launch)


block_front.launches = 0


def _pad_hidden(t, hidden, hp, dim):
    """Split [content | gate] along ``dim`` and zero-pad each to ``hp``."""
    cont, gate = t.split(hidden, dim=dim)
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, hp - hidden]
    return torch.cat([F.pad(cont, pad), F.pad(gate, pad)], dim=dim)


def gdfn_weights(p: GDFNParams, c: int, hp: int):
    """LN2 + GDFN weights as K2 and K3 take them. [content | gate] is
    padded with zeros to ``hp`` each; padded channels give gelu(0) * 0 = 0
    and meet zero rows of W_out. Returns W_cg (C, 2 hp) bf16, its bias,
    the taps (9, 2 hp) and their bias fp32, W_out (hp, C) bf16, b_out and
    LN2's affine fp32."""
    hidden = p.out_w.shape[1]
    wcg = _pad_hidden(p.in_w.reshape(2 * hidden, c).t(), hidden, hp, 1)
    wcg = wcg.to(torch.bfloat16).contiguous()
    dwcg = _pad_hidden(p.dw_w.reshape(2 * hidden, 9).t().float(), hidden,
                       hp, 1).contiguous()
    bcg = None if p.in_b is None else _pad_hidden(_f32(p.in_b), hidden, hp, 0)
    dbcg = (None if p.dw_b is None
            else _pad_hidden(_f32(p.dw_b), hidden, hp, 0))
    wo = F.pad(p.out_w.reshape(c, hidden).t(), (0, 0, 0, hp - hidden))
    wo = wo.to(torch.bfloat16).contiguous()
    return (wcg, bcg, dwcg, dbcg, wo, _f32(p.out_b), _f32(p.ln_w),
            _f32(p.ln_b))


def block_apply_gdfn(v, x, atw, p: BlockParams, eps: float = 1e-5,
                     c_real=None):
    """Pass 2: the block output (B, H, W, C) in x's dtype.

    v, x: (B, H, W, C) bf16 on the GPU; atw: (B, C, C) bf16 from
    :func:`finalize`; c_real as :func:`block_front` takes it (LN2).
    """
    refuse_export("block_apply_gdfn (K2)")
    if x.device.type == "cpu":
        return block_apply_gdfn_ref(v, x, atw, p, eps, c_real)
    from image_restoration_tpu_torch.kernels.build import load_library

    for name, t in (("v", v), ("x", x), ("atw", atw)):
        _check_input(name, t, x)
    b, h, w, c = x.shape
    if not takes_width(c) or v.shape != x.shape or atw.shape != (b, c, c):
        raise ValueError(f"block_apply_gdfn: v {tuple(v.shape)}, x "
                         f"{tuple(x.shape)}, atw {tuple(atw.shape)}; C must "
                         f"be a multiple of 16")
    if v.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("v and x must start on a 16-byte boundary (the "
                         "kernel copies 16 bytes at a time)")
    hidden = p.out_w.shape[1]
    hp = -(-hidden // _HIDDEN_CHUNK) * _HIDDEN_CHUNK
    _check_params(p, x)
    lib = load_library()
    warps = _apply_warps(c)
    th = _pick_tile_rows(
        _APPLY_TILE_ROWS.get(c),
        lambda t: lib.lib.ir_block_apply_gdfn_smem(c, t, warps),
        lambda t: _tiles(b, h, w, t), x.device)
    wcg, bcg, dwcg, dbcg, wo, bo, ln_w, ln_b = gdfn_weights(p.gdfn(), c, hp)
    bp = _f32(p.proj_b)

    def launch():
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = lib.lib.ir_block_apply_gdfn(
                v.data_ptr(), x.data_ptr(), atw.data_ptr(), _ptr(bp),
                ln_w.data_ptr(), _ptr(ln_b), wcg.data_ptr(), _ptr(bcg),
                dwcg.data_ptr(), _ptr(dbcg), wo.data_ptr(), _ptr(bo),
                out.data_ptr(), b, h, w, c, c_real or c, hp, th, warps,
                float(eps), stream)
        lib.check(code, "block_apply_gdfn")
        block_apply_gdfn.launches += 1
        return out

    return forward_only("block_apply_gdfn", (v, x, atw, *p), launch)


block_apply_gdfn.launches = 0


def pad_front_params(p: FrontParams, lay: Layout) -> FrontParams:
    """The front's parameters in ``lay``'s padded space: LN1's affine, the
    qkv 1x1's rows (per q, k, v slot) and columns, the depthwise taps and
    the biases, zero at the pads."""
    return FrontParams(
        pad_channels(p.ln1_w, lay, dim=0), pad_channels(p.ln1_b, lay, dim=0),
        pad_channels(pad_channels(p.qkv_w, lay, 3, 0), lay, dim=1),
        pad_channels(p.qkv_b, lay, 3, 0), pad_channels(p.dw_w, lay, 3, 0),
        pad_channels(p.dw_b, lay, 3, 0))


def pad_gdfn_params(p: GDFNParams, lay: Layout) -> GDFNParams:
    """LN2 + GDFN's parameters in ``lay``'s padded space: LN2's affine, the
    columns of W_in and the rows of W_out and b_out; the hidden side is
    unchanged (:func:`gdfn_weights` pads it)."""
    return GDFNParams(
        pad_channels(p.ln_w, lay, dim=0), pad_channels(p.ln_b, lay, dim=0),
        pad_channels(p.in_w, lay, dim=1), p.in_b, p.dw_w, p.dw_b,
        pad_channels(p.out_w, lay, dim=0), pad_channels(p.out_b, lay, dim=0))


def pad_block_params(p: BlockParams, lay: Layout) -> BlockParams:
    """A block's parameters in ``lay``'s padded space (W_proj on both
    axes); the temperature is per head and stays."""
    return BlockParams(
        *pad_front_params(p.front(), lay), p.temperature,
        pad_channels(pad_channels(p.proj_w, lay, dim=0), lay, dim=1),
        pad_channels(p.proj_b, lay, dim=0), *pad_gdfn_params(p.gdfn(), lay))


def _block_passes(x, p: BlockParams, num_heads, eps, gate):
    """Pass 1, the finalize and pass 2, in K1's padded layout
    (:func:`front_layout`) where C or the head width is not a multiple of
    16: x is padded once, the finalize runs at the real width on the real
    block of each head's Gram, and the output is unpadded once."""
    lay = front_layout(x.shape[-1], num_heads)
    xp, pp = pad_channels(x, lay), pad_block_params(p, lay)
    v, gram, ss = block_front(xp, pp.front(), num_heads, eps, lay.c)
    gram, ss = real_stats(gram, ss, lay)
    atw = pad_square(finalize(gram, ss, p.temperature, p.proj_w, x.dtype,
                              gate), lay)
    return unpad_channels(block_apply_gdfn(v, xp, atw, pp, eps, lay.c), lay)


class _FusedBlock(RecomputeVJP):
    """The JAX ``fused_block`` custom VJP: ``_fwd`` keeps (x, gate,
    params), ``_bwd`` is ``jax.vjp`` of ``_reference_block`` at them."""


def fused_block(x, p: BlockParams, num_heads: int, eps: float = 1e-5,
                gate=None):
    """One whole TransformerBlock on (B, H, W, C): pass 1, finalize, pass 2,
    at any C in ``num_heads`` heads (padded where the raw kernels do not
    take the width, :func:`_block_passes`). ``p.temperature`` may be per
    sample (B, heads), and ``gate`` (B, C) an output gate, as
    :func:`finalize` takes them (CG-IR's CGTB).

    Differentiable in x, every parameter and ``gate``: the backward is
    that of :func:`reference_block`, recomputed (:class:`_FusedBlock`).
    Without a gradient to take, the passes run as they are."""
    return recompute_vjp(
        _FusedBlock,
        lambda x, gate, *q: _block_passes(x, BlockParams(*q), num_heads, eps,
                                          gate),
        lambda x, gate, *q: reference_block(x, BlockParams(*q), num_heads,
                                            eps, gate=gate),
        (x, gate, *p))
