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
JAX. Plain torch throughout; eval only, as MoCE-IR.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from image_restoration_tpu_torch.models.moce_ir import (
    DecoderBlock,
    MoCEUNet,
    expert_banks,
)
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.common import Conv, Linear
from image_restoration_tpu_torch.ops.moe import noisy_topk_gates


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
    """Per-token top-k gate, eval path (moce_ir_patch.py:524-609): an
    ``num_experts``-channel fp32 conv with kernel and stride
    ``patch_size`` (``gate.0``) plus the broadcast fp32 frequency gate."""

    def __init__(self, dim: int, freq_dim: int, num_experts: int, k: int,
                 patch_size: int = 16):
        super().__init__()
        self.k = k
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

    def forward(self, x, freq_emb):
        """(gates (B * P, E), top_idx, top_vals), fp32."""
        if self.training:
            raise NotImplementedError(
                "MoE routing serves eval only: the routing noise and the "
                "aux losses are the MoCE family's training slice (ROADMAP "
                "Queue 1 item 4)")
        return noisy_topk_gates(self.logits(x, freq_emb), self.k)


class PatchAdapterLayer(nn.Module):
    """The adapter over tokens (moce_ir_patch.py:392-521): every expert on
    every token, accumulated expert by expert with the token's gate cast
    to the expert output's dtype, merged back, then ``proj_out``."""

    def __init__(self, dim: int, rank: int, num_experts: int = 4,
                 top_k: int = 2, rank_type: str = "constant",
                 freq_dim: int = 128, patch_size: int = 16, dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.routing = PatchRoutingFunction(dim, freq_dim, num_experts, top_k,
                                            patch_size)
        self.experts = expert_banks(dim, rank, num_experts, rank_type, dtype)
        self.proj_out = Conv(dim, dim, 1, bias=False, dtype=dtype)

    def forward(self, x, freq_emb, shared):
        b, _, h, w = x.shape
        gates, _, _ = self.routing(x, freq_emb)
        xt = patch_split(x, self.patch_size)
        st = patch_split(shared, self.patch_size)
        out = torch.zeros_like(xt)
        for i, e in enumerate(self.experts):
            eo = e[0](xt, st)
            out = out + eo * gates[:, i].to(eo.dtype)[:, None, None, None]
        return self.proj_out(patch_merge(out, b, h, w))


class PatchDecoderBlock(DecoderBlock):
    """MoCE-IR's DecoderBlock with the patch adapter
    (moce_ir_patch.py:636-687)."""

    make_adapter = PatchAdapterLayer


@register_model("moce_ir_patch")
class MoCEIRPatch(MoCEUNet, nn.Module):
    """moce_ir_patch.py:820-953. Takes and returns NCHW; the output is
    fp32. ``depth_type``, ``stage_depth``, ``with_complexity`` and
    ``complexity_scale`` set the complexity statistic of training and
    change nothing in eval."""

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
                patch_size=patch_size)

        self._build(inp_channels, out_channels, dim, levels, heads,
                    num_blocks, num_dec_blocks, num_refinement_blocks,
                    use_bias, decoder, dtype, expansion=ffn_expansion_factor,
                    use_bias=True, ln_type=ln_type)
