"""Patch-routed MoCE-IR (the reference's moce_ir_patch.py;
image_restoration_tpu/models/moce_ir_patch.py), NCHW: MoCE-IR whose
decoder routes every ``patch_size`` x ``patch_size`` token on its own.

The routing logits of a token are a strided fp32 conv over it (kernel and
stride ``patch_size``) plus the image's frequency gate; its gates are their
softmax kept at the top-k. As in JAX, the reference's sparse dispatch
(broken scratch code there, moce_ir_patch.py:496-519) becomes the intended
dense math: every expert runs on every token, weighted by the token's
gates, so experts whose Fourier patch is larger than the token (32 on 16)
zero-pad each token inside ``FFTAttention``. The input is zero-padded to
max(2^(levels-1), patch_size x 2^(levels-2)), so every decoder level
splits into whole tokens. The encoder runs plain EncoderBlocks, as in
JAX. Plain torch throughout. Training routes every token with noise and
returns the aux loss as MoCE-IR does; its load loss is the per-token one
over the flattened (B * P, E) logits, as the JAX module chose over the
reference's, which reads only the last patch's thresholds
(moce_ir_patch.py:585).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from image_restoration_tpu_torch.models.moce_ir import (
    DecoderBlock,
    MoCEUNet,
    expert_banks,
    expert_complexity,
)
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.common import Conv, Linear
from image_restoration_tpu_torch.ops.moe import route


def patch_split(x, p: int):
    """(B, C, H, W) -> (B * P, C, p, p): the row-major p x p tokens of each
    image (moce_ir_patch.py:22)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, c, p, p)


def patch_merge(x, b: int, h: int, w: int):
    """Inverse of :func:`patch_split`: (B * P, C, p, p) -> (B, C, H, W)."""
    c, p = x.shape[1], x.shape[-1]
    x = x.reshape(b, h // p, w // p, c, p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


class PatchRoutingFunction(nn.Module):
    """Per-token noisy top-k gate (moce_ir_patch.py:524-609): an
    ``num_experts``-channel fp32 conv with kernel and stride
    ``patch_size`` (``gate.0``) plus the broadcast fp32 frequency gate,
    routed by ``ops/moe.py`` ``route`` over the (B * P, E) tokens;
    ``complexity`` as MoCE-IR's ``RoutingFunction`` takes it."""

    def __init__(self, dim: int, freq_dim: int, num_experts: int, k: int,
                 patch_size: int = 16, complexity=None):
        super().__init__()
        self.k = k
        self.register_buffer("complexity", None if complexity is None
                             else torch.tensor(complexity), persistent=False)
        self.gate = nn.Sequential(
            Conv(dim, num_experts, patch_size, stride=patch_size, bias=True,
                 dtype=torch.float32))
        self.freq_gate = Linear(freq_dim, num_experts, bias=False,
                                dtype=torch.float32)

    def logits(self, x, freq_emb):
        """(B * P, E) fp32 logits, tokens row-major within each image."""
        spatial = self.gate(x.float())
        b, e = spatial.shape[:2]
        spatial = spatial.reshape(b, e, -1).transpose(1, 2)  # (B, P, E)
        freq = self.freq_gate(freq_emb.float())
        return (spatial + freq[:, None, :]).reshape(-1, e)

    def forward(self, x, freq_emb, train=False, generator=None):
        """(gates (B * P, E), top_idx, top_vals, aux), fp32."""
        return route(self.logits(x, freq_emb), self.k, train, generator,
                     self.complexity)


class PatchAdapterLayer(nn.Module):
    """The adapter over tokens (moce_ir_patch.py:392-521): every expert on
    every token, accumulated expert by expert with the token's gate cast
    to the expert output's dtype, merged back, then ``proj_out``; in
    training ``(out, aux)``, as MoCE-IR's ``AdapterLayer``."""

    def __init__(self, dim: int, rank: int, num_experts: int = 4,
                 top_k: int = 2, rank_type: str = "constant",
                 freq_dim: int = 128, patch_size: int = 16,
                 with_complexity: bool = False, complexity_scale: str = "max",
                 dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.routing = PatchRoutingFunction(
            dim, freq_dim, num_experts, top_k, patch_size,
            expert_complexity(dim, rank, num_experts, rank_type,
                              complexity_scale) if with_complexity else None)
        self.experts = expert_banks(dim, rank, num_experts, rank_type, dtype)
        self.proj_out = Conv(dim, dim, 1, bias=False, dtype=dtype)

    def forward(self, x, freq_emb, shared, train=False, generator=None):
        b, _, h, w = x.shape
        gates, _, _, aux = self.routing(x, freq_emb, train=train,
                                        generator=generator)
        xt = patch_split(x, self.patch_size)
        st = patch_split(shared, self.patch_size)
        out = torch.zeros_like(xt)
        for i, e in enumerate(self.experts):
            eo = e[0](xt, st)
            out = out + eo * gates[:, i].to(eo.dtype)[:, None, None, None]
        out = self.proj_out(patch_merge(out, b, h, w))
        return (out, aux) if train else out


class PatchDecoderBlock(DecoderBlock):
    """MoCE-IR's DecoderBlock with the patch adapter
    (moce_ir_patch.py:636-687)."""

    make_adapter = PatchAdapterLayer


@register_model("moce_ir_patch")
class MoCEIRPatch(MoCEUNet, nn.Module):
    """moce_ir_patch.py:820-953. Takes and returns NCHW; the output is
    fp32, and ``(out, {"aux_loss": ...})`` with ``train`` (MoCE-IR's
    ``forward``). ``with_complexity`` and ``complexity_scale`` set the
    complexity bias of training's importance loss; ``depth_type`` and
    ``stage_depth`` change nothing."""

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
                 patch_size: int = 16, with_complexity: bool = False,
                 complexity_scale: str = "max", dtype=None):
        super().__init__()
        self.pad_multiple = max(2 ** (levels - 1),
                                patch_size * 2 ** (levels - 2))

        def decoder(i, d, h, freq_dim):
            return PatchDecoderBlock(
                d, h, ffn_expansion_factor, use_bias, ln_type, dtype,
                rank=rank, num_experts=num_experts, top_k=topk,
                rank_type=rank_type, freq_dim=freq_dim,
                patch_size=patch_size, with_complexity=with_complexity,
                complexity_scale=complexity_scale)

        self._build(inp_channels, out_channels, dim, levels, heads,
                    num_blocks, num_dec_blocks, num_refinement_blocks,
                    use_bias, decoder, dtype, expansion=ffn_expansion_factor,
                    use_bias=True, ln_type=ln_type)
