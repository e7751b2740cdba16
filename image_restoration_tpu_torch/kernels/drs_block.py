"""Whole DRSformer TransformerBlock in two passes over the image.

Port of image_restoration_tpu/kernels/drs_block_pallas.py. The block is
x + TKSA(LN1(x)), then + MSFN(LN2(.)) (DRSformer_arch.py:62-186). TKSA has
MDTA's front, so one block is

* pass 1, ``kernels.block.block_front`` (CUDA ``csrc/block_front.cu``, the
  Restormer block's pass 1 as it stands): LN1, qkv 1x1, 3x3 depthwise; v,
  and the per-head q^T k Gram and sums of squares of q and k;
* :func:`tksa_finalize` (plain torch, O(heads ch^2)): the top-k masked
  softmaxes at four sparsity levels, mixed by attn1..attn4, folded with
  W_proj into A^T W_proj;
* pass 2, :func:`drs_apply_msfn` (CUDA ``csrc/drs_apply_msfn.cu``):
  ao = x + v @ (A^T W_proj) + b, LN2, and the whole mixed-scale FFN with its
  residual, without the 2 hidden-wide intermediates ever reaching device
  memory.

MSFN, as the reference computes it: u = project_in(y) (2H channels);
d3 = relu(dw3x3(u)), d5 = relu(dw5x5(u)); for path p in (0, 1), a grouped
conv with H groups of two input channels over cat(d3_p, d5_p), where d3_p,
d5_p are the p-th halves (3x3 for p = 0, 5x5 for p = 1); relu; project_out
of the two paths' concat. Group g of path p reads channels 2g and 2g + 1 of
its concat, so with an odd H one group pairs d3_p[H-1] with d5_p[0].

Kernel functions take (B, H, W, C) contiguous tensors. On a CUDA tensor a
wrapper launches its kernel, or raises if the kernel cannot take the input;
on a CPU tensor it runs its plain version, which rounds where the kernel
rounds when given bf16 and does not round at all in fp32. Each wrapper
counts its launches in ``.launches``.

:func:`fused_drs_block` takes every width, in K1's padded layout
(``kernels/block.py`` ``front_layout``, :func:`pad_drs_params`; LN2's
statistics over the real channels, :func:`tksa_finalize` at the real
width), and differentiates as the JAX ``fused_drs_block``
custom VJP does (``drs_block_pallas.py:630-659``): the forward launches K1
and K7 and keeps only the block input and the parameters; the backward
recomputes :func:`reference_drs_block` (JAX ``_reference_drs_block``) and
differentiates that, launching nothing (:class:`_DRSBlock`).
:func:`drs_apply_msfn` called alone is forward only: on CUDA tensors that
require grad its ``backward()`` raises (``kernels/forward_only.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from image_restoration_tpu_torch.kernels.block import (
    FrontParams,
    RecomputeVJP,
    _check_input,
    _check_params,
    _f32,
    _matmul_1x1,
    _ptr,
    block_front,
    front_layout,
    pad_front_params,
    recompute_vjp,
    takes_width,
)
from image_restoration_tpu_torch.kernels.build import refuse_export
from image_restoration_tpu_torch.kernels.forward_only import forward_only
from image_restoration_tpu_torch.kernels.widths import (
    Layout,
    pad_channels,
    pad_square,
    real_stats,
    unpad_channels,
)
from image_restoration_tpu_torch.ops.attention import (
    tksa_attention,
    topk_mixture,
)
from image_restoration_tpu_torch.ops.layernorm import layer_norm_f32

Tensor = torch.Tensor


class DRSBlockParams(NamedTuple):
    """One DRSformer TransformerBlock's parameters in torch layout (fp32).

    The first six fields are pass 1's (:class:`FrontParams`). Biases are
    None where the convs or the LN are bias-free."""

    ln1_w: Tensor
    ln1_b: Optional[Tensor]
    qkv_w: Tensor              # (3C, C, 1, 1), output channels [q | k | v]
    qkv_b: Optional[Tensor]
    dw_w: Tensor               # (3C, 1, 3, 3)
    dw_b: Optional[Tensor]
    temperature: Tensor        # (heads, 1, 1)
    mix: Tensor                # (4,): attn1..attn4
    proj_w: Tensor             # (C, C, 1, 1)
    proj_b: Optional[Tensor]
    ln2_w: Tensor
    ln2_b: Optional[Tensor]
    in_w: Tensor               # (2H, C, 1, 1)
    in_b: Optional[Tensor]
    dw3_w: Tensor              # (2H, 1, 3, 3)
    dw3_b: Optional[Tensor]
    dw5_w: Tensor              # (2H, 1, 5, 5)
    dw5_b: Optional[Tensor]
    s3_w: Tensor               # (H, 2, 3, 3): path 0's grouped conv
    s3_b: Optional[Tensor]
    s5_w: Tensor               # (H, 2, 5, 5): path 1's grouped conv
    s5_b: Optional[Tensor]
    out_w: Tensor              # (C, 2H, 1, 1)
    out_b: Optional[Tensor]

    def front(self) -> FrontParams:
        return FrontParams(*self[:len(FrontParams._fields)])


# ------------------------------------------------------------ plain parts ---

def tksa_finalize(gram, ss, temperature, mix, proj_w, dtype):
    """A^T W_proj per batch, (B, C, C) in ``dtype``, from pass 1's Gram and
    sums of squares (after drs_block_pallas.py:543-562).

    The logits are the Gram divided by the outer product of the clamped q
    and k norms, then times the temperature, in that order, so the top-k
    masks see the values the JAX package's do. W_proj is rounded to
    ``dtype`` first, as the TPU kernel packs it.
    """
    b, heads, ch, _ = gram.shape
    c = heads * ch
    qn = torch.sqrt(ss[:, 0]).clamp_min(1e-12).reshape(b, heads, ch)
    kn = torch.sqrt(ss[:, 1]).clamp_min(1e-12).reshape(b, heads, ch)
    logits = gram / (qn[..., :, None] * kn[..., None, :])
    logits = logits * temperature.reshape(1, heads, 1, 1).float()
    a = topk_mixture(logits, mix)
    wp = proj_w.reshape(c, c).t().to(dtype).float().reshape(heads, ch, c)
    return torch.matmul(a.transpose(-1, -2), wp).reshape(b, c, c).to(dtype)


def _conv(t, w, b, padding, groups):
    """Zero-padded conv of a (B, H, W, N) fp32 tensor with fp32 weights."""
    y = F.conv2d(t.permute(0, 3, 1, 2), w.float(), _f32(b), padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _path_inputs(d3, d5, hidden, path):
    """cat(d3_p, d5_p), the input of path p's grouped conv."""
    sl = slice(path * hidden, (path + 1) * hidden)
    return torch.cat([d3[..., sl], d5[..., sl]], dim=-1)


def drs_apply_msfn_ref(v, x, atw, p: DRSBlockParams, eps: float = 1e-5,
                       c_real=None):
    """Plain version of :func:`drs_apply_msfn`; output in x's dtype.

    Rounds to x's dtype where the TPU kernel rounds: y before project_in; u
    after its bias; d3 and d5 after relu; each path's sums after bias and
    relu; the output. ao stays fp32.
    """
    dt = x.dtype
    b, h, w, c = x.shape
    hidden = p.s3_w.shape[0]
    ao = torch.bmm(v.float().reshape(b, h * w, c), atw.float())
    ao = ao.reshape(b, h, w, c) + x.float()
    if p.proj_b is not None:
        ao = ao + p.proj_b.float()
    y = layer_norm_f32(ao, p.ln2_w, p.ln2_b, eps, c_real).to(dt).float()
    u = _matmul_1x1(y, p.in_w, p.in_b, dt).to(dt).float()
    d3 = torch.relu(_conv(u, p.dw3_w, p.dw3_b, 1, 2 * hidden)).to(dt).float()
    d5 = torch.relu(_conv(u, p.dw5_w, p.dw5_b, 2, 2 * hidden)).to(dt).float()
    s = [torch.relu(_conv(_path_inputs(d3, d5, hidden, path), wt, bias,
                          pad, hidden)).to(dt).float()
         for path, (wt, bias, pad) in enumerate(((p.s3_w, p.s3_b, 1),
                                                 (p.s5_w, p.s5_b, 2)))]
    out = _matmul_1x1(torch.cat(s, dim=-1), p.out_w, p.out_b, dt) + ao
    return out.to(dt)


def reference_drs_block(x, p: DRSBlockParams, num_heads: int,
                        eps: float = 1e-5):
    """The block as the plain composition of its ops, on (B, H, W, C):
    counterpart of the JAX ``drs_block_pallas._reference_drs_block``. Every
    conv runs in x's dtype; LN statistics, norms and softmaxes in fp32."""
    dt = x.dtype
    hidden = p.s3_w.shape[0]

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
    attn = tksa_attention(q, k, v, p.temperature, p.mix, num_heads)
    x = x + conv(attn.permute(0, 2, 3, 1), p.proj_w, p.proj_b)
    u = conv(ln(x, p.ln2_w, p.ln2_b), p.in_w, p.in_b)
    d3 = torch.relu(conv(u, p.dw3_w, p.dw3_b, 2 * hidden, 1))
    d5 = torch.relu(conv(u, p.dw5_w, p.dw5_b, 2 * hidden, 2))
    s0 = torch.relu(conv(_path_inputs(d3, d5, hidden, 0), p.s3_w, p.s3_b,
                         hidden, 1))
    s1 = torch.relu(conv(_path_inputs(d3, d5, hidden, 1), p.s5_w, p.s5_b,
                         hidden, 2))
    return x + conv(torch.cat([s0, s1], dim=-1), p.out_w, p.out_b)


# ---------------------------------------------------------------- kernels ---

GROUPS_PER_CHUNK = 16  # csrc/drs_apply_msfn.cu NG
U_SEGMENTS = 5         # csrc/drs_apply_msfn.cu NSEGU
CHUNK_INTS = 16        # csrc/drs_apply_msfn.cu CT_INTS


@functools.lru_cache(maxsize=None)
def msfn_chunks(hidden: int, ng: int = GROUPS_PER_CHUNK):
    """How the kernel walks MSFN's stage-2 groups, chunk by chunk.

    A chunk holds ``ng`` groups of one path whose two operands come from
    one stage-1 bank size: the pure-3x3 groups (both operands from d3) with
    k1 = 3, then the rest (d5 operands, and the odd-H group whose d3
    operand takes its 3x3 taps zero-padded to 5x5) with k1 = 5. Each
    (path, k1) list is padded with empty groups to a multiple of ``ng``.
    Operand o of group g reads u channel ``src`` through tap table ``kind``
    (0: 3x3, 1: 3x3 padded to 5x5, 2: 5x5).

    Returns numpy arrays: ``meta`` (chunks, 2) of (k1, k2); per group slot
    ``group`` (path * H + g, or -1 when empty); per operand slot ``src``
    (-1 when empty) and ``kind``.
    """
    meta, group, src, kind = [], [], [], []
    for path in (0, 1):
        k2 = 3 if path == 0 else 5
        pure3 = [g for g in range(hidden) if 2 * g + 1 < hidden]
        rest = [g for g in range(hidden) if 2 * g + 1 >= hidden]
        for k1, groups in ((3, pure3), (5, rest)):
            n = -(-len(groups) // ng) * ng
            for gi in range(n):
                if gi >= len(groups):
                    group.append(-1)
                    src += [-1, -1]
                    kind += [0, 0]
                    continue
                g = groups[gi]
                group.append(path * hidden + g)
                for i in (2 * g, 2 * g + 1):  # concat indices of the pair
                    if i < hidden:            # d3 operand
                        src.append(path * hidden + i)
                        kind.append(0 if k1 == 3 else 1)
                    else:                     # d5 operand
                        src.append(path * hidden + i - hidden)
                        kind.append(2)
            meta += [(k1, k2)] * (n // ng)
    return dict(meta=np.asarray(meta, np.int32),
                group=np.asarray(group, np.int64),
                src=np.asarray(src, np.int64), kind=np.asarray(kind, np.int64))


@functools.lru_cache(maxsize=None)
def msfn_u_tables(hidden: int):
    """Where the kernel finds each chunk's operands in u.

    The pre kernel stores u in its natural channel order with each path's
    H channels padded to ``hp`` (a multiple of 8), so u is ``2 hp`` wide and
    u channel ``path * H + c`` lies at ``pos = path * hp + c``. A chunk
    stages up to five 8-channel segments of u a pixel; operand o reads
    column ``col`` of them: segment ``col // 8``, channel ``col % 8``.

    Returns ``hp`` and ``ctab`` (chunks, 16) int32, the kernel's chunk
    records: k1, k2, the five segments' first positions (-1: none), 0, then
    the 32 operands' columns as bytes (an empty slot reads column 0).
    """
    lay = msfn_chunks(hidden)
    hp = -(-hidden // 8) * 8
    src = lay["src"]
    pos = np.where(src < 0, -1, src // hidden * hp + src % hidden)
    no = 2 * GROUPS_PER_CHUNK
    nch = lay["meta"].shape[0]
    ctab = np.zeros((nch, CHUNK_INTS), np.int32)
    for j in range(nch):
        p = pos[j * no:(j + 1) * no]
        segs = sorted(set((p[p >= 0] // 8 * 8).tolist()))
        assert len(segs) <= U_SEGMENTS, (hidden, j, segs)
        cols = np.asarray([0 if q < 0 else segs.index(q // 8 * 8) * 8 + q % 8
                           for q in p], np.uint8)
        ctab[j, :2] = lay["meta"][j]
        ctab[j, 2:2 + U_SEGMENTS] = segs + [-1] * (U_SEGMENTS - len(segs))
        ctab[j, 8:] = cols.view("<i4")
    return dict(hp=hp, ctab=ctab)


@functools.lru_cache(maxsize=None)
def _chunk_indices(hidden: int, device):
    """:func:`msfn_chunks` and :func:`msfn_u_tables` as device tensors, made
    once per width and device (a copy from host memory would stall the host
    on every call): the u channel of each padded position (W_in, b_in), rows
    of the three stage-1 tap tables, of the 2H groups (stage 2, W_out), and
    the kernel's chunk records. An empty slot indexes one past the table,
    where :func:`_gather` puts a row of zeros."""
    lay = msfn_chunks(hidden)
    ut = msfn_u_tables(hidden)
    h2, hp = 2 * hidden, ut["hp"]
    src, group = lay["src"], lay["group"]
    taps = np.where(src < 0, 3 * h2, lay["kind"] * h2 + src)
    q = np.arange(2 * hp)
    unat = np.where(q % hp < hidden, q // hp * hidden + q % hp, h2)
    return dict(unat=torch.as_tensor(unat, device=device),
                ctab=torch.as_tensor(ut["ctab"], device=device),
                taps=torch.as_tensor(taps, device=device),
                group=torch.as_tensor(np.where(group < 0, h2, group),
                                      device=device),
                nch=lay["meta"].shape[0])


def _gather(table, idx):
    """Rows ``idx`` of ``table`` with a row of zeros appended."""
    return torch.cat([table, table.new_zeros((1,) + table.shape[1:])])[idx]


def _pack_msfn(p: DRSBlockParams, c: int, device):
    """The MSFN weights as the kernel takes them: project_in's columns in
    u's padded natural order (see :func:`msfn_u_tables`) and project_out's
    rows in chunk order (bf16), stage-1 taps (25 per operand slot), stage-2
    taps (2 x 25 per group), their biases (fp32, None when bias-free), and
    the chunk records."""
    hidden = p.s3_w.shape[0]
    ix = _chunk_indices(hidden, torch.device(device))
    h2 = 2 * hidden
    dw3 = p.dw3_w.reshape(h2, 9).float()
    taps1 = torch.cat([F.pad(dw3, (0, 16)),
                       F.pad(dw3.reshape(h2, 3, 3), (1, 1, 1, 1)).reshape(h2, 25),
                       p.dw5_w.reshape(h2, 25).float()])
    taps2 = torch.cat([F.pad(p.s3_w.reshape(hidden, 2, 9).float(), (0, 16)),
                       p.s5_w.reshape(hidden, 2, 25).float()])
    pk = dict(
        win=_gather(p.in_w.reshape(h2, c), ix["unat"]).t()
        .to(torch.bfloat16).contiguous(),
        w1=_gather(taps1, ix["taps"]).contiguous(),
        w2=_gather(taps2, ix["group"]).contiguous(),
        wout=_gather(p.out_w.reshape(c, h2).t(), ix["group"])
        .to(torch.bfloat16).contiguous(),
        ctab=ix["ctab"], nch=ix["nch"])
    pk["bin"] = None if p.in_b is None else _gather(
        p.in_b.float(), ix["unat"]).contiguous()
    pk["b1"] = None if p.dw3_b is None else _gather(
        torch.cat([p.dw3_b, p.dw3_b, p.dw5_b]).float(), ix["taps"]).contiguous()
    pk["b2"] = None if p.s3_b is None else _gather(
        torch.cat([p.s3_b, p.s5_b]).float(), ix["group"]).contiguous()
    return pk


# Tile heights and warps of K7's main kernel (csrc/drs_apply_msfn.cu, built
# for 8 and 16 warps) by channel width, the fastest in ``chip_smoke.py
# --msfn 8 4 2 --warps 8|16`` on an H100 80GB HBM3 (700 W) at DRSformer's
# block shapes on a 512x512 image: 8 warps, two blocks an SM, win where the
# tile's shared memory leaves room for two (C <= 96); at C = 384 only
# th <= 4 holds the output fragments. Other widths take the tallest tile
# that fits, at 16 warps.
_MSFN_TILE_ROWS = {48: 8, 96: 8, 192: 8, 384: 4}
_MSFN_WARPS = {48: 8, 96: 8, 192: 16, 384: 16}


def _msfn_warps(c: int) -> int:
    return _MSFN_WARPS.get(c, 16)


def _msfn_smem(c: int, hidden: int, th: int, warps: int) -> int:
    """Shared memory of one block of the main kernel."""
    from image_restoration_tpu_torch.kernels.build import load_library

    nch = msfn_chunks(hidden)["meta"].shape[0]
    return load_library().lib.ir_drs_apply_msfn_smem(c, th, warps, nch)


def _msfn_launch(b, h, w, c, hidden, device):
    """(tile rows, warps, chunk split) for the card.

    The tile height of ``_MSFN_TILE_ROWS`` if it fits, else the tallest of
    8/4/2/1 rows that fits (shared memory, and a build that holds the
    tile's output fragments). Where the tiles are fewer than two per SM,
    each tile's chunks are split over that many more blocks.
    """
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    nch = msfn_chunks(hidden)["meta"].shape[0]
    warps = _msfn_warps(c)
    rows = (8, 4, 2, 1)
    if c in _MSFN_TILE_ROWS:
        rows = (_MSFN_TILE_ROWS[c],) + rows
    for th in rows:
        if _msfn_smem(c, hidden, th, warps) <= limit:
            tiles = b * -(-h // th) * -(-w // 16)
            split = min(nch, -(-2 * props.multi_processor_count // tiles))
            return th, warps, split
    raise ValueError(f"drs_apply_msfn: C={c} too wide for the card's shared "
                     f"memory")


def drs_apply_msfn(v, x, atw, p: DRSBlockParams, eps: float = 1e-5,
                   c_real=None):
    """Pass 2: the block output (B, H, W, C) in x's dtype.

    v, x: (B, H, W, C) bf16 on the GPU, C a multiple of 16; atw: (B, C, C)
    bf16 from :func:`tksa_finalize`. Any H and W. c_real: the real
    channels of a padded x (``kernels/widths.py``), which LN2's statistics
    take; None for all C.
    """
    refuse_export("drs_apply_msfn (K7)")
    if x.device.type == "cpu":
        return drs_apply_msfn_ref(v, x, atw, p, eps, c_real)
    from image_restoration_tpu_torch.kernels.build import load_library

    for name, t in (("v", v), ("x", x), ("atw", atw)):
        _check_input(name, t, x)
    b, h, w, c = x.shape
    if not takes_width(c) or v.shape != x.shape or atw.shape != (b, c, c):
        raise ValueError(f"drs_apply_msfn: v {tuple(v.shape)}, x "
                         f"{tuple(x.shape)}, atw {tuple(atw.shape)}; C must "
                         f"be a multiple of 16")
    _check_params(p, x)
    lib = load_library()
    hidden = p.s3_w.shape[0]
    pk = _pack_msfn(p, c, x.device)
    th, warps, split = _msfn_launch(b, h, w, c, hidden, x.device)
    ln_w, ln_b = _f32(p.ln2_w), _f32(p.ln2_b)
    bp, bo = _f32(p.proj_b), _f32(p.out_b)
    uw = pk["win"].shape[1]

    def launch():
        u = torch.empty((b, h, w, uw), device=x.device, dtype=torch.bfloat16)
        res = torch.empty(x.shape, device=x.device, dtype=torch.float32)
        out = torch.empty_like(x)
        part = (torch.empty((split,) + x.shape, device=x.device,
                            dtype=torch.float32) if split > 1 else None)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = lib.lib.ir_drs_apply_msfn(
                v.data_ptr(), x.data_ptr(), atw.data_ptr(), _ptr(bp),
                ln_w.data_ptr(), _ptr(ln_b), _ptr(bo), u.data_ptr(),
                res.data_ptr(), pk["win"].data_ptr(), _ptr(pk["bin"]),
                pk["w1"].data_ptr(), _ptr(pk["b1"]), pk["w2"].data_ptr(),
                _ptr(pk["b2"]), pk["wout"].data_ptr(), pk["ctab"].data_ptr(),
                out.data_ptr(), _ptr(part), b, h, w, c, c_real or c, uw,
                pk["nch"], th, warps, split, float(eps), stream)
        lib.check(code, "drs_apply_msfn")
        drs_apply_msfn.launches += 1
        return out

    return forward_only("drs_apply_msfn", (v, x, atw, *p), launch)


drs_apply_msfn.launches = 0


def pad_drs_params(p: DRSBlockParams, lay: Layout) -> DRSBlockParams:
    """A DRSformer block's parameters in ``lay``'s padded space: the
    front's (``kernels/block.py`` ``pad_front_params``), W_proj on both
    axes, b_proj, LN2's affine, project_in's columns, project_out's rows
    and b_out; the temperature, the mix and MSFN's hidden side stay."""
    def pad(t, dim=0):
        return pad_channels(t, lay, dim=dim)

    return DRSBlockParams(
        *pad_front_params(p.front(), lay), p.temperature, p.mix,
        pad(pad(p.proj_w), 1), pad(p.proj_b), pad(p.ln2_w), pad(p.ln2_b),
        pad(p.in_w, 1), p.in_b, p.dw3_w, p.dw3_b, p.dw5_w, p.dw5_b, p.s3_w,
        p.s3_b, p.s5_w, p.s5_b, pad(p.out_w), pad(p.out_b))


def _drs_passes(x, p: DRSBlockParams, num_heads, eps):
    """Pass 1, the TKSA finalize and pass 2 in K1's padded layout
    (``kernels/block.py`` ``front_layout``), as the Restormer pair runs
    them: the top-k masks see only each head's real channels."""
    lay = front_layout(x.shape[-1], num_heads)
    xp, pp = pad_channels(x, lay), pad_drs_params(p, lay)
    v, gram, ss = block_front(xp, pp.front(), num_heads, eps, lay.c)
    gram, ss = real_stats(gram, ss, lay)
    atw = pad_square(tksa_finalize(gram, ss, p.temperature, p.mix, p.proj_w,
                                   x.dtype), lay)
    return unpad_channels(drs_apply_msfn(v, xp, atw, pp, eps, lay.c), lay)


class _DRSBlock(RecomputeVJP):
    """The JAX ``fused_drs_block`` custom VJP: ``_fwd`` keeps (x, params),
    ``_bwd`` is ``jax.vjp`` of ``_reference_drs_block`` at them."""


def fused_drs_block(x, p: DRSBlockParams, num_heads: int, eps: float = 1e-5):
    """One whole DRSformer TransformerBlock on (B, H, W, C): pass 1 (the
    Restormer block's), the TKSA finalize, pass 2.

    Differentiable in x and every parameter (``mix`` included): the
    backward is that of :func:`reference_drs_block`, recomputed. Without a
    gradient to take, the passes run as they are."""
    return recompute_vjp(
        _DRSBlock,
        lambda x, *q: _drs_passes(x, DRSBlockParams(*q), num_heads, eps),
        lambda x, *q: reference_drs_block(x, DRSBlockParams(*q), num_heads,
                                          eps),
        (x, *p))
