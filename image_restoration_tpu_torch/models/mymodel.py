"""MyModel: the tri-branch MoCE variant (MyModel/model.py;
image_restoration_tpu/models/mymodel.py), NCHW.

A MoCE-IR-style U-Net whose encoder blocks mix with :class:`Mix` and whose
decoder is MoCE-IR's, both under zero-initialised layer scales:

* :class:`Mix` (:788-848): the odd channels go to MDTA attention at half
  the width and a 1x1 ``proj_attn`` back to the width; the even channels
  to :class:`GatedDegradationAdaption` (a statistics-modulated gated conv,
  :537-576) and to :class:`IlluFre` (an MLP on the fp32 rfft2's magnitude
  and another on its phase, :508-534); 1x1 projections, a concat, a 1x1,
  exact GELU, an SE channel attention and a 1x1 residual.
* :class:`MyEncoderBlock` (:851-884): x + beta Mix(LN(x)); then x + gamma
  (GDFN(LN(x)) + AdaptIR(LN(x))), with AdaptIR's adapter at hidden =
  dim // ffn_factor, a channel gate reducing by 4 and biases on every
  layer (``models/adaptir_ipt.py`` ``AdaptIRAdapter``). The reference
  block also builds an ``Mlp`` it never calls; it holds no JAX leaf and is
  not built here (:func:`mymodel_key_map` drops its keys).
* :class:`MyDecoderBlock` (:912-955): MoCE-IR's decoder block
  (``models/moce_ir.py``) with its mixer and GDFN scaled by zero-init
  ``beta``/``gamma``.

The reference's ``Mix`` cannot run (it builds full-width norms and
attention for a half-width branch); the JAX package, and this port, attend
at half the width and add ``proj_attn``, as the JAX module docstring sets
out.

``forward(img, train=True, generator=g)`` is the JAX ``train=True``
apply: the routers' noise is drawn from ``g`` (``ops/moe.py``
``routing_noise``), the adapters' BatchNorms run on the batch's statistics
and update the running ones, and the model returns ``(out, {"aux_loss":
the decoder blocks' mean balance loss})``. In eval at batch 1 each
decoder block's adapter runs only its top-1 expert (``AdapterLayer``'s
``switched_eval``), as JAX's ``nn.switch`` does. No Pallas kernel lies
behind this model in JAX: plain torch. Parameters stay fp32 and ``dtype``
is the compute dtype. Attribute paths are the reference's with the
``.layers.`` level flattened (``enc.0.0.0.mixer.local.depthwise_conv
.weight``); :func:`mymodel_key_map` maps a reference checkpoint's keys
onto them and onto the JAX tree.
"""

from __future__ import annotations

import re
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.adair import ChannelCrossAttention
from image_restoration_tpu_torch.models.adaptir_ipt import AdaptIRAdapter
from image_restoration_tpu_torch.models.igmoce_ir import LN
from image_restoration_tpu_torch.models.moce_ir import (
    AdapterLayer, FrequencyEmbedding, gap,
)
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.attention import MDTA
from image_restoration_tpu_torch.ops.common import Conv, gelu_exact
from image_restoration_tpu_torch.ops.fft import _polar, irfft2, rfft2
from image_restoration_tpu_torch.ops.ffn import GDFN
from image_restoration_tpu_torch.ops.resample import Downsample, Upsample


class IlluFre(nn.Module):
    """The fp32 rfft2's magnitude through 1x1 (2 dim), leaky ReLU 0.1, 1x1
    (dim) and its phase through a 1x1, both in the compute dtype; the
    fp32 irfft2 of m e^(i phase), cast to x's dtype. Magnitude and phase
    come from ``ops/fft.py`` ``_polar``."""

    def __init__(self, dim: int, bias: bool = False, dtype=None):
        super().__init__()
        self.process1 = nn.Sequential(
            Conv(dim, dim * 2, 1, bias=bias, dtype=dtype), nn.LeakyReLU(0.1),
            Conv(dim * 2, dim, 1, bias=bias, dtype=dtype))
        self.process2 = nn.Sequential(Conv(dim, dim, 1, bias=bias,
                                           dtype=dtype))

    def forward(self, x):
        h, w = x.shape[-2:]
        z = rfft2(x)
        mag, pha = _polar(z.real, z.imag)
        mag = self.process1(mag.to(x.dtype)).float()
        pha = self.process2(pha.to(x.dtype)).float()
        return irfft2(torch.complex(mag * torch.cos(pha),
                                    mag * torch.sin(pha)), (h, w),
                      dtype=x.dtype)


class GatedDegradationAdaption(nn.Module):
    """A 1x1 to hidden = 2 dim split into gamma (hidden / 2), beta and
    alpha (hidden / 4 each); alpha through a grouped 3x3 of two outputs a
    group (qc -> 2 qc), times 1 + tau, tau = ``initial_temperature``
    sigmoid(mean + std of x over the pixels); GELU(gamma) x 1x1([beta,
    alpha]) + x, then a 1x1 ``projection``."""

    def __init__(self, dim: int, initial_temperature: float = 1.0,
                 dtype=None):
        super().__init__()
        hidden = dim * 2
        qc = hidden // 4
        self.hidden, self.qc = hidden, qc
        self.initial_temperature = initial_temperature
        self.expansion = Conv(dim, hidden, 1, dtype=dtype)
        self.depthwise_conv = Conv(qc, hidden // 2, 3, padding=1, groups=qc,
                                   dtype=dtype)
        self.gate_combination = Conv(3 * qc, hidden // 2, 1, dtype=dtype)
        self.projection = Conv(dim, dim, 1, dtype=dtype)

    def forward(self, x):
        mu = gap(x)[:, :, None, None]
        sigma = torch.sqrt(gap((x - mu) ** 2)[:, :, None, None])
        tau = self.initial_temperature * torch.sigmoid(mu + sigma)
        qc = self.qc
        gamma, beta, alpha = self.expansion(x).split(
            [self.hidden - 2 * qc, qc, qc], dim=1)
        alpha = self.depthwise_conv(alpha) * (1 + tau)
        gated = self.gate_combination(torch.cat([beta, alpha], dim=1))
        return self.projection(gelu_exact(gamma) * gated + x)


class Mix(nn.Module):
    """The tri-branch mixer (model.py:788-848, with the JAX package's fix:
    attention at ``dim // 2`` plus ``proj_attn``)."""

    def __init__(self, dim: int, num_heads: int,
                 initial_temperature: float = 1.0, ln_type: str = "WithBias",
                 bias: bool = False, dtype=None):
        super().__init__()
        half = dim // 2
        self.norm_attn = LN(half, ln_type)
        self.attention = MDTA(half, num_heads, bias, dtype=dtype)
        self.proj_attn = Conv(half, dim, 1, dtype=dtype)
        self.norm_local = LN(half, ln_type)
        self.local = GatedDegradationAdaption(half, initial_temperature,
                                              dtype)
        self.proj_local = Conv(half, dim, 1, dtype=dtype)
        self.norm_illum = LN(half, ln_type)
        self.illumination = IlluFre(half, bias, dtype)
        self.proj_illum = Conv(half, dim, 1, dtype=dtype)
        self.final_proj = Conv(3 * dim, dim, 1, dtype=dtype)
        self.ca = nn.ModuleList([
            nn.Identity(), Conv(dim, dim // 2, 1, dtype=dtype), nn.Identity(),
            Conv(dim // 2, dim, 1, dtype=dtype)])
        self.residual_proj = Conv(dim, dim, 1, dtype=dtype)

    def forward(self, x):
        x_attn, x_local = x[:, 1::2], x[:, 0::2]
        a = self.proj_attn(self.attention(self.norm_attn(x_attn)))
        lo = self.proj_local(self.local(self.norm_local(x_local)))
        il = self.proj_illum(self.illumination(self.norm_illum(x_local)))
        fused = gelu_exact(self.final_proj(torch.cat([a, lo, il], dim=1)))
        caw = self.ca[3](F.relu(self.ca[1](gap(fused)[:, :, None, None])))
        return torch.sigmoid(caw) * fused + self.residual_proj(x)


def _scale(p):
    """A (C,) fp32 layer scale over the channels of NCHW maps: a bf16 map
    times it is fp32, as in JAX, whose bf16 model carries its residual
    stream in fp32 from the first block on."""
    return p[:, None, None]


class MyEncoderBlock(nn.Module):
    """model.py:851-884: x + Mix(LN(x)) beta; then x + (GDFN + AdaptIR)
    (LN(x)) gamma, ``beta`` and ``gamma`` starting at zero."""

    def __init__(self, dim: int, num_heads: int,
                 initial_temperature: float = 1.0, expansion: float = 2.0,
                 ln_type: str = "WithBias", bias: bool = True, dtype=None):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(dim))
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.norms = nn.ModuleList([LN(dim, ln_type), LN(dim, ln_type)])
        self.mixer = Mix(dim, num_heads, initial_temperature, ln_type, bias,
                         dtype)
        self.adaptir = AdaptIRAdapter(dim, int(expansion), 4, dtype,
                                      bias=bias, tail_bias=bias)
        self.ffn = GDFN(dim, expansion, bias, dtype=dtype)

    def forward(self, x, train: bool = False):
        h = self.mixer(self.norms[0](x))
        x = x + h * _scale(self.beta)
        h = self.norms[1](x)
        f = self.ffn(h) + self.adaptir(h, train)
        return x + f * _scale(self.gamma)


class MyDecoderBlock(nn.Module):
    """model.py:912-955: MoCE-IR's decoder block (LN, the shared MDTA
    branch and the expert adapter, the 7x7-kv cross-attention mixer; LN,
    GDFN) with the mixer's output scaled by ``beta`` and the GDFN's by
    ``gamma``, both starting at zero. In training it returns ``(x,
    aux)``, the adapter's balance loss."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.0,
                 bias: bool = False, ln_type: str = "WithBias", rank: int = 2,
                 num_experts: int = 4, top_k: int = 1,
                 rank_type: str = "constant", freq_dim: int = 128,
                 with_complexity: bool = False, complexity_scale: str = "max",
                 switched_eval: bool = True, dtype=None):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(dim))
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.norms = nn.ModuleList([LN(dim, ln_type), LN(dim, ln_type)])
        self.proj = nn.ModuleList([Conv(dim, dim, 1, dtype=dtype),
                                   Conv(dim, dim, 1, dtype=dtype)])
        self.shared = MDTA(dim, num_heads, bias, dtype=dtype)
        self.adapter = AdapterLayer(dim, rank, num_experts, top_k, rank_type,
                                    freq_dim, switched_eval, with_complexity,
                                    complexity_scale, dtype)
        self.mixer = ChannelCrossAttention(dim, num_heads, bias, dtype=dtype,
                                           kv_kernel=7)
        self.ffn = GDFN(dim, expansion, bias, dtype=dtype)

    def forward(self, x, freq_emb, train=False, generator=None):
        xn = self.norms[0](x)
        x_s = self.shared(self.proj[0](xn))
        x_a = self.adapter(self.proj[1](xn), freq_emb, x_s, train, generator)
        if train:
            x_a, aux = x_a
        h = self.mixer(x_a, x_s)
        x = h * _scale(self.beta) + x
        h = self.ffn(self.norms[1](x))
        x = x + h * _scale(self.gamma)
        return (x, aux) if train else x


_FUSE = re.compile(r"(^|\.)(amp|pha)_fuse\.(weight|bias)$")


def mymodel_key_map(key: str):
    """A reference MyModel key -> this model's (and the JAX importer's
    walk): the ResidualGroup ``.layers.`` level flattened, the adapters'
    fuse scales flattened (``amp_fuse.weight`` -> ``amp_fuse_weight``);
    None for the routing ``complexity`` buffer (recomputed) and for the
    encoder blocks' unused ``Mlp`` (the JAX parity test's key map)."""
    if key.endswith("routing.complexity") or (
            ".mlp." in key and not key.startswith("freq_embed")):
        return None
    return _FUSE.sub(r"\1\2_fuse_\3", key.replace(".layers.", "."))


@register_model("mymodel", key_map=mymodel_key_map)
class MyModel(nn.Module):
    """model.py:1049-1167: ``levels`` levels of MyEncoderBlocks (biases on)
    with Downsample, the latent stack and its FrequencyEmbedding, decoder
    levels of Upsample, skip concat, a 1x1 reduce and MyDecoderBlocks, and
    a 3x3 output plus the input. Takes NCHW; returns the fp32 restoration,
    or with ``train`` ``(image, {"aux_loss": ...})``. ``uses_moe_rng``:
    the trainer applies it with ``train=True`` and a generator. The JAX
    training CLI cannot train it (its step applies the parameters alone,
    and the adapters' BatchNorms read ``batch_stats``), and neither does
    the port's: it trains at model level."""

    uses_moe_rng = True

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 32, levels: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 num_blocks: Sequence[int] = (1, 1, 1, 3),
                 num_dec_blocks: Sequence[int] = (1, 1, 1),
                 ffn_expansion_factor: float = 2.0,
                 initial_temperature: float = 1.0, ln_type: str = "WithBias",
                 use_bias: bool = False, rank: int = 2, num_experts: int = 4,
                 depth_type: Any = "lin",
                 stage_depth: Sequence[int] = (3, 2, 1),
                 rank_type: str = "constant", topk: int = 1,
                 with_complexity: bool = False, complexity_scale: str = "max",
                 switched_eval: bool = True, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.num_dec_total = sum(num_dec_blocks)
        dims = [dim * 2 ** i for i in range(levels)]

        def encoders(i, n):
            return nn.ModuleList(
                MyEncoderBlock(dims[i], heads[i], initial_temperature,
                               ffn_expansion_factor, ln_type, True, dtype)
                for _ in range(n))

        self.patch_embed = Conv(inp_channels, dim, 3, padding=1, bias=False,
                                dtype=dtype)
        self.enc = nn.ModuleList(
            nn.ModuleList([encoders(i, num_blocks[i]),
                           Downsample(dims[i], dtype)])
            for i in range(levels - 1))
        self.latent = encoders(levels - 1, num_blocks[-1])
        self.freq_embed = FrequencyEmbedding(dims[-1], dtype)
        rdims, rheads = dims[::-1], list(heads)[::-1]
        rdec = list(num_dec_blocks)[::-1]
        self.dec = nn.ModuleList(
            nn.ModuleList([
                Upsample(rdims[i], dtype),
                Conv(rdims[i], rdims[i + 1], 1, bias=use_bias, dtype=dtype),
                nn.ModuleList(
                    MyDecoderBlock(
                        rdims[i + 1], rheads[i + 1], ffn_expansion_factor,
                        use_bias, ln_type, rank, num_experts, topk,
                        rank_type, rdims[0], with_complexity,
                        complexity_scale, switched_eval, dtype)
                    for _ in range(rdec[i]))])
            for i in range(levels - 1))
        self.output = Conv(dim, out_channels, 3, padding=1, bias=use_bias,
                           dtype=dtype)

    def forward(self, img, train=False, generator=None):
        x = img if self.dtype is None else img.to(self.dtype)
        feats = self.patch_embed(x)
        skips = []
        for blocks, down in self.enc:
            for blk in blocks:
                feats = blk(feats, train)
            skips.append(feats)
            feats = down(feats)
        for blk in self.latent:
            feats = blk(feats, train)
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
        out = (self.output(feats) + x).float()
        if train:
            return out, {"aux_loss": total_aux / self.num_dec_total}
        return out
