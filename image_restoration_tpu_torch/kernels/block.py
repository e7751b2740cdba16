"""Whole Restormer TransformerBlock in two passes over the image.

Port of image_restoration_tpu/kernels/block_pallas.py. One block is

* pass 1, :func:`block_front` (CUDA ``csrc/block_front.cu``): LN1, the qkv
  1x1, the 3x3 depthwise; writes v, and reduces the per-head q^T k Gram and
  the per-channel sums of squares of q and k over the image, so q and k
  never reach device memory;
* :func:`finalize` (plain torch, O(C^2)): norm rescale, temperature,
  per-head softmax, and the fold of A^T into W_proj;
* pass 2, :func:`block_apply_gdfn` (CUDA ``csrc/block_apply_gdfn.cu``):
  x + v @ (A^T W_proj) + b, LN2, the gated-Dconv FFN, and its residual.

Kernel functions take (B, H, W, C) contiguous tensors. On a CUDA tensor a
wrapper launches its kernel, or raises if the kernel cannot take the input;
on a CPU tensor it runs its plain version (``block_front_ref``,
``block_apply_gdfn_ref``), which rounds where the kernel rounds when given
bf16 and does not round at all in fp32. Each wrapper counts its launches in
``.launches``. Forward only: on CUDA tensors that require grad,
``backward()`` raises (``kernels/forward_only.py``); the plain versions
differentiate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from image_restoration_tpu_torch.kernels.forward_only import forward_only
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
    temperature: Tensor        # (heads, 1, 1)
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


def front_qkv_f32(x, p: FrontParams, eps: float = 1e-5):
    """dwconv3(qkv1x1(LN1(x))) in fp32, (B, H, W, 3C), rounded where the
    kernels round before it: the LN output and the 1x1 weights to x's
    dtype; the product and the taps in fp32."""
    dt = x.dtype
    y = layer_norm_f32(x, p.ln1_w, p.ln1_b, eps)
    proj = _matmul_1x1(y.to(dt).float(), p.qkv_w, p.qkv_b, dt)
    return _dwconv3(proj, p.dw_w, p.dw_b)


def block_front_ref(x, p: FrontParams, num_heads: int, eps: float = 1e-5):
    """Plain version of :func:`block_front`.

    Returns v (B, H, W, C) in x's dtype, the per-head Gram q^T k
    (B, heads, ch, ch) fp32 of q and k rounded to x's dtype, and the fp32
    sums of squares of q and k over all pixels (B, 2, C).
    """
    dt = x.dtype
    b, h, w, c = x.shape
    q, k, v = front_qkv_f32(x, p, eps).split(c, dim=-1)
    ch = c // num_heads
    qh = q.to(dt).float().reshape(b, h * w, num_heads, ch)
    kh = k.to(dt).float().reshape(b, h * w, num_heads, ch)
    gram = torch.einsum("bnhi,bnhj->bhij", qh, kh)
    ss = torch.stack([(q * q).sum((1, 2)), (k * k).sum((1, 2))], dim=1)
    return v.to(dt).contiguous(), gram, ss


def attention_softmax(gram, ss, temperature):
    """The per-head attention A (B, heads, ch, ch) fp32 from the Gram and
    the sums of squares: logits are the Gram rescaled by the q and k norms
    (normalization commutes with the contraction), times the per-head
    temperature; A is their softmax over the last axis."""
    b, heads, ch, _ = gram.shape
    qn = torch.sqrt(ss[:, 0]).clamp_min(1e-12).reshape(b, heads, ch)
    kn = torch.sqrt(ss[:, 1]).clamp_min(1e-12).reshape(b, heads, ch)
    logits = gram / (qn[..., :, None] * kn[..., None, :])
    logits = logits * temperature.reshape(-1, heads, 1, 1).float()
    return torch.softmax(logits, dim=-1)


def finalize(gram, ss, temperature, proj_w, dtype):
    """A^T W_proj per batch, (B, C, C) in ``dtype``.

    A (:func:`attention_softmax`) is block-diagonal over heads, so A^T
    W_proj is computed head by head. W_proj is rounded to ``dtype`` first,
    as the TPU kernel packs it.
    """
    b, heads, ch, _ = gram.shape
    c = heads * ch
    a = attention_softmax(gram, ss, temperature)
    wp = proj_w.reshape(c, c).t().to(dtype).float().reshape(heads, ch, c)
    return torch.matmul(a.transpose(-1, -2), wp).reshape(b, c, c).to(dtype)


def gdfn_tail_ref(ao, p: GDFNParams, dt, eps: float = 1e-5):
    """ao + GDFN(LN2(ao)) on fp32 ``ao``, rounded where K2 and K3 round:
    the LN output, the 1x1 weights and gelu * gate to ``dt``; content and
    gate stay fp32 between the 1x1 and the depthwise. Output in ``dt``."""
    y = layer_norm_f32(ao, p.ln_w, p.ln_b, eps)
    cg = _matmul_1x1(y.to(dt).float(), p.in_w, p.in_b, dt)
    cont, gate = _dwconv3(cg, p.dw_w, p.dw_b).chunk(2, dim=-1)
    act = (gelu_exact(cont) * gate).to(dt).float()
    return (_matmul_1x1(act, p.out_w, p.out_b, dt) + ao).to(dt)


def block_apply_gdfn_ref(v, x, atw, p: BlockParams, eps: float = 1e-5):
    """Plain version of :func:`block_apply_gdfn`; output in x's dtype."""
    b, h, w, c = x.shape
    ao = torch.bmm(v.float().reshape(b, h * w, c), atw.float())
    ao = ao.reshape(b, h, w, c) + x.float()
    if p.proj_b is not None:
        ao = ao + p.proj_b.float()
    return gdfn_tail_ref(ao, p.gdfn(), x.dtype, eps)


def reference_block(x, p: BlockParams, num_heads: int, eps: float = 1e-5):
    """The block as the plain composition of its ops, on (B, H, W, C):
    counterpart of the JAX ``block_pallas._reference_block``. Every conv runs
    in x's dtype; LN statistics, norms and softmax in fp32."""
    dt = x.dtype

    def ln(t, w, bias):
        return layer_norm_f32(t, w, bias, eps).to(dt)

    def conv(t, wt, bias, groups=1, padding=0):
        bias = None if bias is None else bias.to(dt)
        out = F.conv2d(t.permute(0, 3, 1, 2), wt.to(dt), bias,
                       padding=padding, groups=groups)
        return out.permute(0, 2, 3, 1)

    qkv = conv(ln(x, p.ln1_w, p.ln1_b), p.qkv_w, p.qkv_b)
    qkv = conv(qkv, p.dw_w, p.dw_b, groups=qkv.shape[-1], padding=1)
    q, k, v = (t.permute(0, 3, 1, 2) for t in qkv.chunk(3, dim=-1))
    attn = mdta_attention(q, k, v, p.temperature, num_heads)
    x = x + conv(attn.permute(0, 2, 3, 1), p.proj_w, p.proj_b)
    hid = conv(ln(x, p.ln2_w, p.ln2_b), p.in_w, p.in_b)
    hid = conv(hid, p.dw2_w, p.dw2_b, groups=hid.shape[-1], padding=1)
    cont, gate = hid.chunk(2, dim=-1)
    act = gelu_exact(cont.float()).to(dt) * gate
    return x + conv(act, p.out_w, p.out_b)


# ---------------------------------------------------------------- kernels ---

_HIDDEN_CHUNK = 32  # csrc/gdfn.cuh NH: hidden padded to this


def _ptr(t):
    return None if t is None else t.data_ptr()


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
# 2x longer. Other widths, or a card with less shared memory, take the rule
# of ``_pick_tile_rows``.
_APPLY_TILE_ROWS = {48: 8, 96: 4, 192: 8, 384: 2}
# Warps per block of K2 and K3 (csrc/gdfn.cuh is built for 8 and 16), from
# the same sweep: 16 warps win where a tile's products are long (C >= 192),
# 8 where more blocks share an SM.
_APPLY_WARPS = {48: 8, 96: 8, 192: 16, 384: 16}
# Tile heights and warps of K1 (csrc/front.cuh, built for 8 and 16 warps),
# the fastest in ``chip_smoke.py --front 8 4 2 1 --warps 8|16`` on the same
# card; K4 has its own (kernels/mdta.py). At C = 384 only 8 warps hold the
# Gram and only th <= 2 fits; at 192, th = 8 does not fit.
_FRONT_TILE_ROWS = {48: 8, 96: 8, 192: 4, 384: 2}
_FRONT_WARPS = {48: 8, 96: 16, 192: 16, 384: 8}


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


def block_front(x, p: FrontParams, num_heads: int, eps: float = 1e-5):
    """Pass 1: (v, gram, ss) as :func:`block_front_ref` documents.

    x: (B, H, W, C) bf16 on the GPU, C and C / num_heads multiples of 16.
    p: FrontParams (``BlockParams.front()``, ``DRSBlockParams.front()``).
    """
    if x.device.type == "cpu":
        return block_front_ref(x, p, num_heads, eps)
    from image_restoration_tpu_torch.kernels.build import load_library

    _check_input("x", x, x)
    b, h, w, c = x.shape
    ch = c // num_heads
    if c % 16 or ch % 16 or ch * num_heads != c:
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
                ss.data_ptr(), b, h, w, c, num_heads, th, warps, grid_x,
                float(eps), stream)
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


def block_apply_gdfn(v, x, atw, p: BlockParams, eps: float = 1e-5):
    """Pass 2: the block output (B, H, W, C) in x's dtype.

    v, x: (B, H, W, C) bf16 on the GPU; atw: (B, C, C) bf16 from
    :func:`finalize`.
    """
    if x.device.type == "cpu":
        return block_apply_gdfn_ref(v, x, atw, p, eps)
    from image_restoration_tpu_torch.kernels.build import load_library

    for name, t in (("v", v), ("x", x), ("atw", atw)):
        _check_input(name, t, x)
    b, h, w, c = x.shape
    if c % 16 or v.shape != x.shape or atw.shape != (b, c, c):
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
                out.data_ptr(), b, h, w, c, hp, th, warps, float(eps),
                stream)
        lib.check(code, "block_apply_gdfn")
        block_apply_gdfn.launches += 1
        return out

    return forward_only("block_apply_gdfn", (v, x, atw, *p), launch)


block_apply_gdfn.launches = 0


def fused_block(x, p: BlockParams, num_heads: int, eps: float = 1e-5):
    """One whole TransformerBlock on (B, H, W, C): pass 1, finalize, pass 2."""
    v, gram, ss = block_front(x, p.front(), num_heads, eps)
    atw = finalize(gram, ss, p.temperature, p.proj_w, x.dtype)
    return block_apply_gdfn(v, x, atw, p, eps)
