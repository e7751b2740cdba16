"""MoCE-IR (moce_ir_orignal.py, CVPR'25): a Restormer-style encoder and a
mixture-of-complexity-experts decoder (image_restoration_tpu/models/
moce_ir.py), NCHW.

* encoder, latent and refinement stacks: ``EncoderBlock`` (LN, MDTA, LN,
  GDFN, every conv with a bias), Restormer's TransformerBlock under other
  names; with ``fused_block`` each is one call of ``kernels/block.py``
  ``fused_block`` (K1, finalize, K2);
* ``FrequencyEmbedding`` of the latent: a high-pass 3x3 depthwise conv,
  GELU, GAP and an MLP;
* ``DecoderBlock``: LN, two 1x1 splits into a shared MDTA branch and an
  ``AdapterLayer``, a mixture of ``ModExpert``s (low-rank projections
  around an ``FFTAttention`` with patch sizes 4/8/16/32, SiLU-gated by the
  shared branch) routed by an image gate plus a frequency gate; a channel
  cross attention (7x7 kv) re-injects the shared branch; LN, GDFN.

``forward(img, train=True, generator=g)`` is the JAX ``train=True`` apply:
every router adds Gaussian noise of std 1/E to its logits, drawn from the
``torch.Generator`` ``g`` (``ops/moe.py`` ``routing_noise``; it raises
without one), and returns 0.5 x importance + 0.5 x load loss, the
importance weighted by the experts' relative parameter counts with
``with_complexity``; the model returns ``(out, {"aux_loss": mean over the
decoder blocks})``. Eval adds no noise and returns the image alone. Top-k
picks keep the lower index on ties (``ops/moe.py``). In eval at batch 1
with top-1 routing the adapter runs only the picked expert, scaled by its
gate; it reads the pick on the host (one sync a decoder block). Every
other case, training included, is the dense combine, so the windows of a
tiled restore take the dense path, as in JAX. The expert depth loop of the
reference never feeds back, so one application is the whole expert.

The TPU workarounds of the JAX module are not ported: its matmul DFT
(``FFTAttention`` runs ``torch.fft`` in fp32, as the JAX CPU path does),
``scan_blocks`` and the canvas padding. Attribute paths are the reference
torch model's with the ``ResidualGroup`` ``.layers.`` level flattened
(``enc.0.0.1.mixer.qkv.weight``); :func:`moce_key_map` maps a reference
state_dict onto them and ``utils/jax_bridge.py`` a JAX tree. Parameters
stay fp32 and ``dtype`` is the compute dtype, as in JAX.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.kernels.block import (
    BlockParams, block_misfits, fused_block,
)
from image_restoration_tpu_torch.models.adair import ChannelCrossAttention
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.attention import MDTA
from image_restoration_tpu_torch.ops.common import Conv, Linear
from image_restoration_tpu_torch.ops.ffn import GDFN
from image_restoration_tpu_torch.ops.layernorm import LayerNorm
from image_restoration_tpu_torch.ops.moe import dense_moe_combine, route
from image_restoration_tpu_torch.ops.resample import Downsample, Upsample


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()  # free when channels-last


def gap(x):
    """Global average pool (B, C, H, W) -> (B, C) in x's dtype, summed in
    fp32 and rounded once, as ``jnp.mean`` rounds a bf16 map."""
    return x.float().mean(dim=(2, 3)).to(x.dtype)


class FFTAttention(nn.Module):
    """Patchified Fourier attention (moce_ir_orignal.py:309-360): q (1x1 +
    3x3 depthwise) and k (1x1 + ``kernel_size`` depthwise), zero-padded to
    a multiple of ``patch_size``, are multiplied patch by patch in rfft2
    space (fp32) and transformed back; the result, cropped and cast to x's
    dtype, goes through a WithBias LN, times v, and ``proj_out``."""

    def __init__(self, dim: int, kernel_size: int = 7, patch_size: int = 8,
                 dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.q = Conv(dim, dim, 1, bias=False, dtype=dtype)
        self.q_dwconv = Conv(dim, dim, 3, padding=1, groups=dim, bias=True,
                             dtype=dtype)
        self.kv = Conv(dim, dim * 2, 1, bias=False, dtype=dtype)
        self.kv_dwconv = Conv(dim * 2, dim * 2, kernel_size,
                              padding=kernel_size // 2, groups=dim * 2,
                              bias=True, dtype=dtype)
        self.norm = LayerNorm(dim, "WithBias")
        self.proj_out = Conv(dim, dim, 1, bias=True, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        p = self.patch_size
        q = self.q_dwconv(self.q(x))
        k, v = self.kv_dwconv(self.kv(x)).chunk(2, dim=1)
        hp, wp = h + (-h) % p, w + (-w) % p

        def spectrum(t):  # (b, c, hp/p, wp/p, p, p//2+1) complex64
            t = F.pad(t.float(), (0, wp - w, 0, hp - h))
            t = t.reshape(b, c, hp // p, p, wp // p, p).transpose(3, 4)
            return torch.fft.rfft2(t)

        out = torch.fft.irfft2(spectrum(q) * spectrum(k), s=(p, p))
        out = out.transpose(3, 4).reshape(b, c, hp, wp)[..., :h, :w]
        out = self.norm(out.to(x.dtype))
        return self.proj_out(out * v)


def fft_attention_param_count(dim: int, kernel_size: int) -> int:
    """Parameters of ``FFTAttention(dim, kernel_size)``: the reference counts
    them at init for the routing complexity bias."""
    return (dim * dim                              # q
            + dim * 9 + dim                        # q_dwconv + bias
            + dim * 2 * dim                        # kv
            + 2 * dim * kernel_size ** 2 + 2 * dim  # kv_dwconv + bias
            + 2 * dim                              # norm weight + bias
            + dim * dim + dim)                     # proj_out + bias


class ModExpert(nn.Module):
    """Low-rank complexity expert (moce_ir_orignal.py ModExpert): project to
    ``rank``, FFTAttention, times SiLU of the shared branch projected to
    ``rank``, project back, plus the input. The reference's FFTAttention
    hard-codes a 7x7 kv depthwise conv whatever kernel size an expert is
    given, and its depth loop never feeds back; both only enter the
    complexity statistic of training."""

    def __init__(self, dim: int, rank: int, patch_size: int, dtype=None):
        super().__init__()
        self.proj = nn.ModuleList([
            Conv(dim, rank, 1, bias=False, dtype=dtype),
            Conv(dim, rank, 1, bias=False, dtype=dtype),
            Conv(rank, dim, 1, bias=False, dtype=dtype)])
        self.body = FFTAttention(rank, 7, patch_size, dtype)

    def forward(self, x, shared):
        h = self.body(self.proj[0](x)) * F.silu(self.proj[1](shared))
        return self.proj[2](h) + x


def expert_param_count(dim: int, rank: int, kernel_size: int = 7) -> int:
    """A ModExpert's parameters (its kv conv is always 7x7): the reference's
    complexity statistic, which weighs the importance loss of training."""
    return dim * rank * 2 + rank * dim + fft_attention_param_count(rank, 7)


def expert_complexity(dim, rank, num_experts, rank_type, scale="max"):
    """Each expert's parameter count over the largest (``scale`` "max") or
    the smallest ("min"): the routers' complexity bias (JAX
    moce_ir.py:254-257). With ``rank_type="constant"`` it is all ones."""
    ranks = _expert_schedules(num_experts, 1, rank, dim, "constant",
                              rank_type)[3]
    counts = [expert_param_count(dim, r) for r in ranks]
    denom = min(counts) if scale == "min" else max(counts)
    return tuple(c / denom for c in counts)


def _expert_schedules(num_experts, stage_depth, rank, dim, depth_type,
                      rank_type):
    """Per-expert (patch sizes, kernel sizes, depths, ranks)
    (moce_ir.py:205-226): patches 4, 8, 16, ...; ``rank_type="spread"``
    gives ranks dim / 2^(E-1), ..., dim / 2, dim. Eval builds its experts
    from the patch sizes and ranks; kernel sizes and depths only enter the
    complexity statistic."""
    patch_sizes = [2 ** (i + 2) for i in range(num_experts)]
    kernel_sizes = [3 + 2 * i for i in range(num_experts)]
    if isinstance(depth_type, int):
        depths = [depth_type] * num_experts
    else:
        depths = {
            "lin": [stage_depth + i for i in range(num_experts)],
            "double": [stage_depth + 2 * i for i in range(num_experts)],
            "exp": [2 ** i for i in range(num_experts)],
            "fact": [math.factorial(i + 1) for i in range(num_experts)],
            "constant": [stage_depth] * num_experts,
        }[depth_type if isinstance(depth_type, str) else "constant"]
    ranks = {
        "constant": [rank] * num_experts,
        "lin": [rank + i for i in range(num_experts)],
        "double": [rank + 2 * i for i in range(num_experts)],
        "exp": [rank ** (i + 1) for i in range(num_experts)],
        "fact": [math.factorial(rank + i) for i in range(num_experts)],
        "spread": [dim // (2 ** i) for i in range(num_experts)][::-1],
    }[rank_type]
    return patch_sizes, kernel_sizes, depths, ranks


def expert_banks(dim, rank, num_experts, rank_type, dtype=None):
    """The adapters' experts, ``experts.i.0`` as in the reference: a
    ModExpert of each schedule's patch size and rank."""
    patches, _, _, ranks = _expert_schedules(num_experts, 1, rank, dim,
                                             "constant", rank_type)
    return nn.ModuleList(nn.ModuleList([ModExpert(dim, r, p, dtype)])
                         for r, p in zip(ranks, patches))


class RoutingFunction(nn.Module):
    """Noisy top-k gate over the experts (moce_ir.py:169-202): logits of
    the image's GAP (rounded to the map's dtype, as ``jnp.mean`` rounds it)
    through ``gate.2`` plus, unless ``use_freq_gate`` is False (IGMoCE-IR),
    the frequency embedding through ``freq_gate``, both fp32; their
    softmax (noisy in training, ``ops/moe.py`` ``route``), kept at the
    top-k. ``complexity`` (the experts' relative parameter counts,
    :func:`expert_complexity`), when given, weighs training's importance
    loss: the JAX ``complexity`` with ``use_complexity_bias``. ``gate``
    keeps the reference's (pool, flatten, linear) Sequential for its
    checkpoint paths; the pool runs as :func:`gap`."""

    def __init__(self, dim: int, freq_dim: int, num_experts: int, k: int,
                 complexity=None, use_freq_gate: bool = True):
        super().__init__()
        self.k = k
        self.register_buffer("complexity", None if complexity is None
                             else torch.tensor(complexity), persistent=False)
        self.gate = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(),
            Linear(dim, num_experts, bias=False, dtype=torch.float32))
        self.freq_gate = (Linear(freq_dim, num_experts, bias=False,
                                 dtype=torch.float32)
                          if use_freq_gate else None)

    def logits(self, x, freq_emb=None):
        """(B, E) fp32 routing logits."""
        out = self.gate[2](gap(x).float())
        if self.freq_gate is not None:
            out = out + self.freq_gate(freq_emb.float())
        return out

    def forward(self, x, freq_emb=None, train=False, generator=None):
        """(gates (B, E), top_idx (B, k), top_vals (B, k), aux), fp32;
        ``aux`` is 0 unless ``train``."""
        return route(self.logits(x, freq_emb), self.k, train, generator,
                     self.complexity)


class AdapterLayer(nn.Module):
    """The mixture of ModExperts (moce_ir_orignal.py AdapterLayer,
    moce_ir.py:229-290), then a 1x1 ``proj_out``.

    With ``switched_eval``, in eval at batch 1 and top-1 with more than
    one expert, only the picked expert runs, scaled by its fp32 gate cast
    to the expert output's dtype: the dense combine's value, since the
    other gates are 0. The pick is read on the host. Otherwise, training
    included, every expert runs and the outputs are combined densely by
    the gates. In training it returns ``(out, aux)``: the router's
    balance loss, its importance weighted by the experts' complexity with
    ``with_complexity``."""

    def __init__(self, dim: int, rank: int, num_experts: int = 4,
                 top_k: int = 2, rank_type: str = "constant",
                 freq_dim: int = 128, switched_eval: bool = True,
                 with_complexity: bool = False, complexity_scale: str = "max",
                 dtype=None):
        super().__init__()
        self.top_k = top_k
        self.switched_eval = switched_eval
        self.routing = RoutingFunction(
            dim, freq_dim, num_experts, top_k,
            expert_complexity(dim, rank, num_experts, rank_type,
                              complexity_scale) if with_complexity else None)
        self.experts = expert_banks(dim, rank, num_experts, rank_type, dtype)
        self.proj_out = Conv(dim, dim, 1, bias=False, dtype=dtype)

    def forward(self, x, freq_emb, shared, train=False, generator=None):
        gates, top_idx, top_vals, aux = self.routing(
            x, freq_emb, train=train, generator=generator)
        if (self.switched_eval and not train and x.shape[0] == 1
                and self.top_k == 1 and len(self.experts) > 1):
            o = self.experts[int(top_idx[0, 0])][0](x, shared)
            out = top_vals[0, 0].to(o.dtype) * o
        else:
            out = dense_moe_combine(gates, [e[0](x, shared)
                                            for e in self.experts])
        out = self.proj_out(out)
        return (out, aux) if train else out


class EncoderBlock(nn.Module):
    """LN -> MDTA -> +res; LN -> GDFN -> +res (moce_ir_orignal.py:573-588):
    Restormer's TransformerBlock with the names ``norms.0``, ``mixer``,
    ``norms.1``, ``ffn``. With ``fused_block`` it runs as the kernel pair
    of ``kernels/block.py`` on the (B, H, W, C) view of channels-last x."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.0,
                 use_bias: bool = True, ln_type: str = "WithBias",
                 fused_block: bool = False, dtype=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.fused_block = fused_block
        self.norms = nn.ModuleList([LayerNorm(dim, ln_type),
                                    LayerNorm(dim, ln_type)])
        self.mixer = MDTA(dim, num_heads, use_bias, dtype=dtype)
        self.ffn = GDFN(dim, expansion, use_bias, dtype=dtype)

    def kernel_misfits(self) -> dict:
        """The kernel flags on that this block's width rules out."""
        return block_misfits(self.dim, self.num_heads, self.fused_block)

    def block_params(self) -> BlockParams:
        n1, n2 = self.norms[0].body, self.norms[1].body
        at, ff = self.mixer, self.ffn
        return BlockParams(
            n1.weight, getattr(n1, "bias", None),
            at.qkv.weight, at.qkv.bias, at.qkv_dwconv.weight,
            at.qkv_dwconv.bias, at.temperature, at.project_out.weight,
            at.project_out.bias,
            n2.weight, getattr(n2, "bias", None),
            ff.project_in.weight, ff.project_in.bias, ff.dwconv.weight,
            ff.dwconv.bias, ff.project_out.weight, ff.project_out.bias)

    def forward(self, x):
        if self.fused_block:
            out = fused_block(_nhwc(x), self.block_params(), self.num_heads,
                              1e-5)
            return out.permute(0, 3, 1, 2)
        x = x + self.mixer(self.norms[0](x))
        return x + self.ffn(self.norms[1](x))


class DecoderBlock(nn.Module):
    """LN, 1x1 splits into the shared MDTA branch (``proj.0``) and the
    adapter (``proj.1``), the cross-attention mixer of the adapter's output
    with the shared branch, plus the input; LN -> GDFN -> +res
    (moce_ir.py:342-378). In training it returns ``(x, aux)``, the
    adapter's balance loss."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.0,
                 use_bias: bool = False, ln_type: str = "WithBias",
                 dtype=None, **adapter_kw):
        super().__init__()
        self.norms = nn.ModuleList([LayerNorm(dim, ln_type),
                                    LayerNorm(dim, ln_type)])
        self.proj = nn.ModuleList([Conv(dim, dim, 1, bias=True, dtype=dtype),
                                   Conv(dim, dim, 1, bias=True, dtype=dtype)])
        self.shared = MDTA(dim, num_heads, use_bias, dtype=dtype)
        self.adapter = self.make_adapter(dim, dtype=dtype, **adapter_kw)
        self.mixer = ChannelCrossAttention(dim, num_heads, use_bias,
                                           dtype=dtype, kv_kernel=7)
        self.ffn = GDFN(dim, expansion, use_bias, dtype=dtype)

    make_adapter = AdapterLayer

    def forward(self, x, freq_emb, train=False, generator=None):
        xn = self.norms[0](x)
        x_s = self.shared(self.proj[0](xn))
        x_a = self.adapter(self.proj[1](xn), freq_emb, x_s, train, generator)
        if train:
            x_a, aux = x_a
        x = self.mixer(x_a, x_s) + x
        x = x + self.ffn(self.norms[1](x))
        return (x, aux) if train else x


class FrequencyEmbedding(nn.Module):
    """High-pass 3x3 depthwise conv -> GELU -> GAP -> Linear -> GELU ->
    Linear (moce_ir_orignal.py:743-764). The conv starts as the 8-neighbour
    Laplacian; the reference means it frozen but never freezes it, so it is
    a parameter. The Linears compute in ``dtype``."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        conv = Conv(dim, dim, 3, padding=1, groups=dim, bias=False,
                    dtype=dtype)
        with torch.no_grad():
            conv.weight.fill_(-1.0)
            conv.weight[:, :, 1, 1] = 8.0
        self.high_conv = nn.Sequential(conv, nn.GELU())
        self.mlp = nn.Sequential(Linear(dim, 2 * dim, dtype=dtype), nn.GELU(),
                                 Linear(2 * dim, dim, dtype=dtype))

    def forward(self, x):
        return self.mlp(gap(self.high_conv(x)))


def _zero_pad_to(x, multiple: int):
    """Zero-pad H and W of NCHW ``x`` after the end to ``multiple``
    (``jnp.pad``'s default)."""
    h, w = x.shape[-2:]
    return F.pad(x, (0, (-w) % multiple, 0, (-h) % multiple))


class MoCEUNet:
    """The U-Net the MoCE-IR models share (moce_ir.py:539-607): patch
    embed, EncoderBlock stacks a level with Downsample, the latent stack
    and its FrequencyEmbedding, decoder levels of Upsample, skip concat, a
    1x1 reduce and ``decoder`` blocks, the refinement stack and the output
    conv, with a residual to the input zero-padded to ``pad_multiple``.
    The stacks run on channels-last maps, so the kernel pair reads their
    (B, H, W, C) views."""

    def _build(self, inp_channels, out_channels, dim, levels, heads,
               num_blocks, num_dec_blocks, num_refinement_blocks, out_bias,
               decoder, dtype, **enc):
        """``decoder(i, dim, heads, freq_dim)``: a block of decoder level
        ``i``; ``out_bias``: the reduce and output convs' bias; ``enc``:
        EncoderBlock's options."""
        self.dtype = dtype
        self.num_dec_total = sum(num_dec_blocks)
        dims = [dim * 2 ** i for i in range(levels)]

        def stack(d, h, n):
            return nn.ModuleList(EncoderBlock(d, h, dtype=dtype, **enc)
                                 for _ in range(n))

        self.patch_embed = Conv(inp_channels, dim, 3, padding=1, bias=False,
                                dtype=dtype)
        self.enc = nn.ModuleList(
            nn.ModuleList([stack(dims[i], heads[i], num_blocks[i]),
                           Downsample(dims[i], dtype)])
            for i in range(levels - 1))
        self.latent = stack(dims[-1], heads[-1], num_blocks[-1])
        self.freq_embed = FrequencyEmbedding(dims[-1], dtype)
        rdims, rheads = dims[::-1], list(heads)[::-1]
        rdec = list(num_dec_blocks)[::-1]
        self.dec = nn.ModuleList(
            nn.ModuleList([
                Upsample(rdims[i], dtype),
                Conv(rdims[i], rdims[i + 1], 1, bias=out_bias, dtype=dtype),
                nn.ModuleList(decoder(i, rdims[i + 1], rheads[i + 1],
                                      rdims[0]) for _ in range(rdec[i]))])
            for i in range(levels - 1))
        self.refinement = stack(dim, heads[0], num_refinement_blocks)
        self.output = Conv(dim, out_channels, 3, padding=1, bias=out_bias,
                           dtype=dtype)

    @staticmethod
    def _run(stack, x):
        x = x.contiguous(memory_format=torch.channels_last)
        for blk in stack:
            x = blk(x)
        return x

    def forward(self, img, train=False, generator=None):
        """The restored image, fp32; with ``train`` ``(image, {"aux_loss":
        the decoder blocks' mean balance loss})``, the routers' noise drawn
        from ``generator``."""
        h, w = img.shape[-2:]
        x = _zero_pad_to(img, self.pad_multiple)
        x = x if self.dtype is None else x.to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = self.patch_embed(x)
        skips = []
        for stack, down in self.enc:
            feats = self._run(stack, feats)
            skips.append(feats)
            feats = down(feats)
        feats = self._run(self.latent, feats)
        freq_emb = self.freq_embed(feats)
        total_aux = 0.0
        for up, reduce, blocks in self.dec:
            feats = reduce(torch.cat([up(feats), skips.pop()], dim=1))
            for blk in blocks:
                if train:
                    feats, aux = blk(feats, freq_emb, True, generator)
                    total_aux = total_aux + aux
                else:
                    feats = blk(feats, freq_emb)
        feats = self._run(self.refinement, feats)
        out = (self.output(feats) + x).float()[..., :h, :w]
        if train:
            return out, {"aux_loss": total_aux / self.num_dec_total}
        return out


def moce_key_map(key: str):
    """Reference torch key -> this model's key (and the JAX importer's
    walk): the ResidualGroup ``.layers.`` level flattened
    (``enc.0.0.layers.1.`` -> ``enc.0.0.1.``); None for the routing
    ``complexity`` buffer, a static statistic the model recomputes
    (the JAX ``moce_key_map``)."""
    if key.endswith("routing.complexity"):
        return None
    return key.replace(".layers.", ".")


@register_model("moce_ir", key_map=moce_key_map)
class MoCEIR(MoCEUNet, nn.Module):
    """moce_ir_orignal.py:769-887, with the modified copy's pad of the input
    to 2^(levels-1). Takes and returns NCHW; the output is fp32, the
    padded input's residual cropped back. ``with_complexity`` and
    ``complexity_scale`` set the complexity bias of training's importance
    loss; ``depth_type`` and ``stage_depth`` change nothing (the experts'
    depth never feeds back, and the bias counts ranks alone, as in JAX).
    ``uses_moe_rng``: the trainer applies it with ``train=True`` and a
    generator (``cli/train.py`` ``model_apply_kwargs``)."""

    uses_moe_rng = True

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 32, levels: int = 3,
                 heads: Sequence[int] = (2, 4, 8),
                 num_blocks: Sequence[int] = (1, 2, 3),
                 num_dec_blocks: Sequence[int] = (2, 4),
                 ffn_expansion_factor: float = 2.0,
                 num_refinement_blocks: int = 1, ln_type: str = "WithBias",
                 use_bias: bool = False, rank: int = 2, num_experts: int = 4,
                 depth_type: Any = "lin",
                 stage_depth: Sequence[int] = (3, 2, 1),
                 rank_type: str = "constant", topk: int = 2,
                 with_complexity: bool = False, complexity_scale: str = "max",
                 switched_eval: bool = True, fused_block: bool = False,
                 dtype=None):
        super().__init__()
        self.pad_multiple = 2 ** (levels - 1)

        def decoder(i, d, h, freq_dim):
            return DecoderBlock(
                d, h, ffn_expansion_factor, use_bias, ln_type, dtype,
                rank=rank, num_experts=num_experts, top_k=topk,
                rank_type=rank_type, freq_dim=freq_dim,
                switched_eval=switched_eval, with_complexity=with_complexity,
                complexity_scale=complexity_scale)

        self._build(inp_channels, out_channels, dim, levels, heads,
                    num_blocks, num_dec_blocks, num_refinement_blocks,
                    use_bias, decoder, dtype, expansion=ffn_expansion_factor,
                    use_bias=True, ln_type=ln_type, fused_block=fused_block)
