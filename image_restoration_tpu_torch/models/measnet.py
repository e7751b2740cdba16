"""MEASNet (multi-expert adaptive selection), the all-in-one restoration
model of image_restoration_tpu/models/measnet.py, NCHW.

A Restormer U-Net with:

* ``Taskprompt``: a dictionary-atom prompt from the degraded image;
* ``STPG_G_MESE``: a per-pixel top-2-of-6 MLP-expert mixture at the first
  encoder input, conditioned on the prompt, combined as log(sum_k w_k
  exp(expert_k(x))) over all experts densely (exact and static-shape);
* ``FD_MEE`` at each decoder input: a learned per-group low-pass split
  (``FD``, a GAP-driven 3x3 kernel over reflect padding) and two ``MEE``
  mixtures (``MESE``: striped conv, recursive strided calibration, and
  top-2-of-5 gated low-rank experts batched into three products);
* ``FreqBlock`` after the latent and decoder levels 3 and 2: the input
  image's adaptive FFT bands cross-attended into the decoder features.

``forward(img, train=True, generator=g)`` is the JAX model's
``apply(..., train=True, mutable=["batch_stats"])``: ``TokenMoE`` adds
noise of a learned per-token std (softplus(x ``w_n``) + 0.01, the draw
from ``g`` through ``ops/moe.py`` ``routing_noise``) and returns its
balance loss; ``stpg_g_mese2``/``stpg_g_mese3``, whose outputs feed only
that loss, run for it; FD's BatchNorm normalises with the batch's
statistics and updates its running ones; the model returns ``(out,
{"aux_loss": the three mixtures' losses summed})``. In eval they are built
(so checkpoints load) but not run, and no loss is computed. Top-k picks
keep the lower index on ties, as ``jax.lax.top_k`` does (``ops/moe.py``
``topk_lower_index``, the MoCE routers' rule too). The reference
quirks the JAX module lists stay: FreqBlock's ``initial_conv`` and
``score_generator``, MEE's ``norm_2`` and FD's ``lamb_l``/``lamb_h`` exist
and are unused, and FreqBlock's low band is empty whenever H < 2 x 128.

The stacks are Restormer TransformerBlocks through ``BlockStackMixin``
(40 a forward at the defaults), so ``fused_block`` runs each as K1 + K2.
MESE's calibration applies a stride-4 conv twice at decoder level 3 (1/8
scale), so inputs need H and W of at least 128, as in the reference.
Parameters stay fp32 and ``dtype`` is the compute dtype, as in JAX; FD's
BatchNorm computes in fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.adair import (
    SpatialGate,
    frequency_bands,
)
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.models.restormer import (
    BlockStackMixin,
    OverlapPatchEmbed,
)
from image_restoration_tpu_torch.ops.attention import (
    normalized_channel_logits_tok_minor,
)
from image_restoration_tpu_torch.ops.common import (
    Conv,
    GroupedConv,
    Linear,
    gelu_exact,
)
from image_restoration_tpu_torch.ops.layernorm import BatchNorm2d, LayerNorm2d
from image_restoration_tpu_torch.ops import moe as moe_ops
from image_restoration_tpu_torch.ops.moe import topk_lower_index
from image_restoration_tpu_torch.ops.resample import (
    Downsample,
    Upsample,
    resize_bilinear,
)

_EPS64 = 2.220446049250313e-16  # np.finfo(float).eps (STPG_G_MESE.py:26)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class Taskprompt(nn.Module):
    """Degraded image -> prompt (B, atom_dim): a strided conv net, GAP, a
    softmax over atoms, the atoms' mix, GELU (MEASNet.py:77-98). The mix
    promotes to the dictionary's fp32, as in JAX."""

    def __init__(self, atom_num: int = 32, atom_dim: int = 256,
                 inp_channels: int = 3, dtype=None):
        super().__init__()
        lrelu = lambda: nn.LeakyReLU(0.1)  # noqa: E731
        self.CondNet = nn.Sequential(
            Conv(inp_channels, 64, 3, stride=3, dtype=dtype), lrelu(),
            Conv(64, 64, 3, stride=3, dtype=dtype), lrelu(),
            Conv(64, 64, 1, dtype=dtype), lrelu(),
            Conv(64, 64, 1, dtype=dtype), lrelu(),
            Conv(64, 32, 1, dtype=dtype))
        self.lastOut = Linear(32, atom_num, dtype=dtype)
        self.dictionary = nn.Parameter(torch.randn(atom_num, atom_dim))

    def forward(self, x):
        h = self.CondNet(x).mean(dim=(2, 3))
        logits = torch.softmax(self.lastOut(h), dim=-1)
        dt = torch.promote_types(logits.dtype, self.dictionary.dtype)
        return gelu_exact(logits.to(dt) @ self.dictionary.to(dt))


class _Mlp(nn.Module):
    """Expert MLP: fc1, exact GELU, fc2 (STPG_G_MESE.py:31-42)."""

    def __init__(self, dim: int, hidden: int, out: int, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, out, dtype=dtype)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


def _balance(x):
    """CV^2 of ``x`` (E,) with the unbiased variance, 0 for one expert
    (STPG_G_MESE.py:60-64; the JAX ``_balance``)."""
    if x.shape[0] == 1:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    xf = x.float()
    return xf.var() / (xf.mean() ** 2 + 1e-10)


class TokenMoE(nn.Module):
    """Per-pixel noisy top-k MLP experts on [x; prompt] gate logits
    (STPG_G_MESE.py:44-121; the JAX ``TokenMoE``): every expert runs on
    every token and the combine is log(sum_e g_e exp(out_e)) in fp32, a
    zero sum clamped to float eps, accumulated expert by expert as JAX
    does. In training the logits take noise of std softplus([x; prompt]
    ``w_n``) + 0.01, and it returns ``(y, loss)``: the balance of the gate
    mass plus that of the smooth load, each token's chance of its expert
    staying in the top k under fresh noise through the normal CDF."""

    def __init__(self, dim: int, mlp_ratio: float, num_experts: int = 6,
                 k: int = 2, dtype=None):
        super().__init__()
        self.k, self.num_experts = k, num_experts
        self.w_g = nn.Parameter(torch.randn(2 * dim, num_experts))
        self.w_n = nn.Parameter(torch.zeros(2 * dim, num_experts))
        self.el = nn.ModuleList(
            _Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)
            for _ in range(num_experts))

    def forward(self, x, prompt, train=False, generator=None):
        b, c, h, w = x.shape
        k = self.k
        tokens = _nhwc(x).reshape(b * h * w, c)
        pr = prompt[:, None, :].expand(b, h * w, c).reshape(b * h * w, c)
        xp = torch.cat([tokens, pr], dim=-1)
        dt = torch.promote_types(xp.dtype, self.w_g.dtype)
        logits = xp.to(dt) @ self.w_g.to(dt)
        if train:
            std = F.softplus(xp.to(dt) @ self.w_n.to(dt)) + 1e-2
            noisy = logits + moe_ops.routing_noise(
                logits.shape, generator, logits.device).to(dt) * std
            top, idx = topk_lower_index(noisy, min(k + 1, self.num_experts))
        else:
            top, idx = topk_lower_index(logits, k)
        gates = torch.zeros_like(logits).scatter_(
            -1, idx[:, :k], torch.softmax(top[:, :k], dim=-1)).float()
        if train:
            if k < self.num_experts:
                thr_in, thr_out = top[:, k:k + 1], top[:, k - 1:k]
                p_in = torch.special.ndtr((logits - thr_in) / std)
                p_out = torch.special.ndtr((logits - thr_out) / std)
                load = torch.where(noisy > thr_in, p_in, p_out).sum(dim=0)
            else:
                load = (gates > 0).float().sum(dim=0)
            loss = _balance(gates.sum(dim=0)) + _balance(load)
        ensemble = 0.0
        for i, expert in enumerate(self.el):
            ensemble = ensemble + gates[:, i:i + 1] * torch.exp(
                expert(tokens).float())
        ensemble = torch.where(ensemble == 0, _EPS64, ensemble)
        y = _nchw(torch.log(ensemble).to(x.dtype).reshape(b, h, w, c))
        return (y, loss) if train else y


class STPG_G_MESE(nn.Module):
    """x + TokenMoE(x, fc(prompt)) (STPG_G_MESE.py:123-131); in training
    ``(x + ..., loss)``."""

    def __init__(self, atom_dim: int, dim: int, mlp_ratio: float,
                 dtype=None):
        super().__init__()
        self.fc = Linear(atom_dim, dim, dtype=dtype)
        self.model = TokenMoE(dim, mlp_ratio, dtype=dtype)

    def forward(self, x, prompt, train=False, generator=None):
        out = self.model(x, self.fc(prompt), train, generator)
        if train:
            return out[0] + x, out[1]
        return out + x


# ---------------------------------------------------------------- FD_MEE ----


class FD(nn.Module):
    """Learned per-group low-pass split (FD_MEE.py:11-39): GAP -> 1x1 ->
    BatchNorm -> softmax over the k x k taps gives a spatially constant
    kernel per (sample, group), applied to reflect-padded x as k^2 shifted
    multiply-adds. Returns (low, x - low). The BatchNorm computes in fp32
    as the JAX ``BatchNorm2d``: with ``train`` (the forward's argument, not
    the module's mode) from the batch's statistics, updating the running
    ones with the unbiased variance and momentum 0.1; else from the
    running ones."""

    def __init__(self, channels: int, kernel_size: int = 3, group: int = 8,
                 dtype=None):
        super().__init__()
        self.k, self.group = kernel_size, group
        self.lamb_l = nn.Parameter(torch.zeros(channels))
        self.lamb_h = nn.Parameter(torch.zeros(channels))
        self.conv = Conv(channels, group * kernel_size ** 2, 1, bias=False,
                         dtype=dtype)
        self.bn = BatchNorm2d(group * kernel_size ** 2)

    def _batch_norm(self, f, train):
        bn = self.bn
        return F.batch_norm(f.float(), bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, train, bn.momentum,
                            bn.eps).to(f.dtype)

    def forward(self, x, train=False):
        k, g = self.k, self.group
        b, c, h, w = x.shape
        filt = self._batch_norm(
            self.conv(x.mean(dim=(2, 3), keepdim=True)), train)
        filt = torch.softmax(filt.reshape(b, g, k * k), dim=-1)
        wmap = filt.repeat_interleave(c // g, dim=1).to(x.dtype)
        p = k // 2
        xp = F.pad(x, (p, p, p, p), mode="reflect")
        low = 0.0
        for i in range(k):
            for j in range(k):
                low = low + (xp[:, :, i:i + h, j:j + w]
                             * wmap[:, :, i * k + j, None, None])
        return low, x - low


class StripedConv2d(nn.Module):
    """A 1xk then a kx1 depthwise conv (FD_MEE.py:162-178)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 depthwise: bool = True, dtype=None):
        super().__init__()
        p, g = kernel_size // 2, channels if depthwise else 1
        self.conv = nn.Sequential(
            GroupedConv(channels, channels, (1, kernel_size), (0, p), g,
                        dtype=dtype),
            GroupedConv(channels, channels, (kernel_size, 1), (p, 0), g,
                        dtype=dtype))

    def forward(self, x):
        return self.conv(x)


class _WET(nn.Module):
    """The expert gate's logits from the pooled features, a bias-free
    Linear at the reference Sequential's index 2 (FD_MEE.py:148-160: pool,
    flatten, Linear); it takes the pooled vector."""

    def __init__(self, channels: int, num_experts: int, dtype=None):
        super().__init__()
        self.body = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(),
            Linear(channels, num_experts, bias=False, dtype=dtype))

    def forward(self, gvec):
        return self.body[2](gvec)


class _EL(nn.Module):
    """A low-rank gated expert's 1x1 convs (FD_MEE.py:133-146): conv_3(
    conv_1(x) * conv_2(k)). ``MESE`` batches all experts' products."""

    def __init__(self, channels: int, low_dim: int):
        super().__init__()
        self.conv_1 = Conv(channels, low_dim, 1)
        self.conv_2 = Conv(channels, low_dim, 1)
        self.conv_3 = Conv(low_dim, channels, 1)


def _lr_dims(lr_space: str, n: int):
    grow = {"linear": lambda i: i + 2, "exp": lambda i: 2 ** (i + 1),
            "double": lambda i: 2 * i + 2}[lr_space]
    return [grow(i) for i in range(n)]


class MESE(nn.Module):
    """Striped conv, strided calibration and top-k gated low-rank experts
    (FD_MEE.py:49-131). The experts run as three products over their
    concatenated rank dims, as JAX batches them: sum_i g_i conv3_i(conv1_i(
    x) * conv2_i(k)) = ((x W1 + b1) * (k W2 + b2) * g) W3 + sum_i g_i b3_i,
    the last product accumulated in fp32."""

    def __init__(self, channels: int, num_experts: int = 5, topk: int = 2,
                 recursive: int = 2, lr_space: str = "linear", dtype=None):
        super().__init__()
        c = channels
        self.topk, self.recursive = topk, recursive
        self.lows = _lr_dims(lr_space, num_experts)
        self.conv_1 = nn.Sequential(
            Conv(c, c, 3, padding=1, dtype=dtype), nn.GELU(),
            Conv(c, 2 * c, 1, dtype=dtype))
        self.conv_2 = nn.Sequential(StripedConv2d(c, 3, dtype=dtype),
                                    nn.GELU())
        self.agg_conv = nn.Sequential(
            Conv(c, c, 4, stride=4, groups=c, dtype=dtype), nn.GELU())
        self.conv = nn.Sequential(
            Conv(c, c, 3, padding=1, groups=c, dtype=dtype),
            Conv(c, c, 1, dtype=dtype))
        self.wet = _WET(c, num_experts, dtype=dtype)
        self.experts = nn.ModuleList(_EL(c, low) for low in self.lows)
        self.proj = Conv(c, c, 1, dtype=dtype)

    def _expert_weights(self, dt):
        """W1, b1, W2, b2 (C, sum lows) and W3 (sum lows, C) in ``dt``."""
        def cat(name, which, dim):
            ts = [getattr(getattr(e, name), which) for e in self.experts]
            if which == "weight":
                ts = [t.reshape(t.shape[0], t.shape[1]).t() for t in ts]
            return torch.cat(ts, dim=dim).to(dt)

        return (cat("conv_1", "weight", 1), cat("conv_1", "bias", 0),
                cat("conv_2", "weight", 1), cat("conv_2", "bias", 0),
                cat("conv_3", "weight", 0))

    def forward(self, x):
        xh, kh = self.conv_1(x).chunk(2, dim=1)
        xh = self.conv_2(xh)
        hh, ww = kh.shape[-2:]
        kcal = kh
        for _ in range(self.recursive):
            kcal = self.agg_conv(kcal)
        kcal = self.conv(kcal)  # resized in fp32: no bf16 CPU kernel
        kcal = resize_bilinear(kcal.float(), hh, ww).to(kcal.dtype)
        kh = kh + kcal

        weights = torch.softmax(self.wet(xh.mean(dim=(2, 3))).float(),
                                dim=-1).to(x.dtype)
        top, idx = topk_lower_index(weights, self.topk)
        gates = torch.zeros_like(weights).scatter_(-1, idx, top)

        dt = xh.dtype
        w1, b1, w2, b2, w3 = self._expert_weights(dt)
        gcols = torch.cat([gates[:, i:i + 1].expand(-1, low)
                           for i, low in enumerate(self.lows)], dim=1)
        e1 = _nhwc(xh) @ w1 + b1
        e2 = _nhwc(kh) @ w2 + b2
        prod = e1 * e2 * gcols[:, None, None, :]
        addon = prod.float() @ w3.float()
        b3 = torch.stack([e.conv_3.bias for e in self.experts]).float()
        b3term = gates.float() @ b3
        out = _nhwc(xh) + (addon + b3term[:, None, None, :]).to(dt)
        return self.proj(_nchw(out))


class MEE(nn.Module):
    """LayerNorm2d -> MESE -> + x (FD_MEE.py:202-218); ``norm_2`` is built
    and unused, as in the reference."""

    def __init__(self, channels: int, num_experts: int = 5, topk: int = 2,
                 dtype=None):
        super().__init__()
        self.norm_1 = LayerNorm2d(channels)
        self.block = MESE(channels, num_experts, topk, dtype=dtype)
        self.norm_2 = LayerNorm2d(channels)

    def forward(self, x):
        return self.block(self.norm_1(x)) + x


class FD_MEE(nn.Module):
    """FD split -> MEE on each band -> 1x1 projection of [high; low]
    (FD_MEE.py:223-253), the projection as two half products accumulated
    in fp32."""

    def __init__(self, channels: int, num_experts: int = 5, dtype=None):
        super().__init__()
        self.spilit = FD(channels, dtype=dtype)
        self.high_block = MEE(channels, num_experts, dtype=dtype)
        self.low_block = MEE(channels, num_experts, dtype=dtype)
        self.proj = Conv(2 * channels, channels, 1)

    def forward(self, x, train=False):
        low, high = self.spilit(x, train)
        high, low = self.high_block(high), self.low_block(low)
        c, dt = x.shape[1], x.dtype
        wp = self.proj.weight.reshape(c, 2 * c).t().to(dt).float()
        out = (_nhwc(high).float() @ wp[:c] + _nhwc(low).float() @ wp[c:]
               + self.proj.bias.float())
        return _nchw(out.to(dt))


# ------------------------------------------------------- frequency Block ----


class CrossAttention(nn.Module):
    """MDTA-style channel cross attention, q from x, k and v from y
    (MEASNet.py:150-176), token-minor as in the reference."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False,
                 dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.q = Conv(dim, dim, 1, bias=bias, dtype=dtype)
        self.q_dwconv = Conv(dim, dim, 3, padding=1, groups=dim, bias=bias,
                             dtype=dtype)
        self.kv = Conv(dim, dim * 2, 1, bias=bias, dtype=dtype)
        self.kv_dwconv = Conv(dim * 2, dim * 2, 3, padding=1,
                              groups=dim * 2, bias=bias, dtype=dtype)
        self.project_out = Conv(dim, dim, 1, bias=bias, dtype=dtype)

    def forward(self, x, y):
        b, c, h, w = x.shape
        q = self.q_dwconv(self.q(x))
        k, v = self.kv_dwconv(self.kv(y)).chunk(2, dim=1)

        def heads(t):  # (B, heads, c / heads, HW)
            return t.reshape(b, self.num_heads, c // self.num_heads, h * w)

        attn = normalized_channel_logits_tok_minor(heads(q), heads(k))
        attn = torch.softmax(attn * self.temperature.float(), dim=-1)
        out = torch.matmul(attn.to(v.dtype), heads(v))
        return self.project_out(out.reshape(b, c, h, w))


# channel max and mean -> 7x7 conv -> sigmoid (MEASNet.py:188-200): AdaIR's
# module, with the same parameter name
_SpatialGate = SpatialGate


class _ChannelGate(nn.Module):
    """A shared MLP on the average and max pools -> sigmoid
    (MEASNet.py:202-213)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.squential = nn.Sequential(
            Conv(dim, dim // 16, 1, bias=False, dtype=dtype), nn.ReLU(),
            Conv(dim // 16, dim, 1, bias=False, dtype=dtype))

    def forward(self, x):
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        return torch.sigmoid(self.squential(avg) + self.squential(mx))


class Modulate(nn.Module):
    """Exchange gates between the bands, sum, project (MEASNet.py:215-228)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.modulate1 = _SpatialGate(dtype)
        self.modulate2 = _ChannelGate(dim, dtype)
        self.conv = Conv(dim, dim, 1, dtype=dtype)

    def forward(self, low, high):
        out = low * self.modulate1(high) + high * self.modulate2(low)
        return self.conv(out)


class FreqBlock(nn.Module):
    """The input image's adaptive FFT bands cross-attended into the decoder
    features (MEASNet.py:230-283): ``out * alpha + y * beta``, which
    promotes to the parameters' fp32 as in JAX."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False,
                 segments: int = 128, inp_channels: int = 3, dtype=None):
        super().__init__()
        self.segments = segments
        # built and unused, as in the reference (MEASNet.py:233-236)
        self.initial_conv = Conv(inp_channels, dim, 3, padding=1, bias=False,
                                 dtype=dtype)
        self.score_generator = Conv(2, 2, 7, padding=3, dtype=dtype)
        self.aux_conv = Conv(inp_channels, dim, 3, padding=1, bias=False,
                             dtype=dtype)
        self.rate_adaptive_conv = nn.Sequential(
            Conv(dim, dim // 8, 1, bias=False, dtype=dtype), nn.GELU(),
            Conv(dim // 8, 2, 1, bias=False, dtype=dtype))

        def cross():
            return CrossAttention(dim, num_heads, bias, dtype=dtype)

        self.cross_layer_low = cross()
        self.cross_layer_high = cross()
        self.cross_layer_agg = cross()
        self.freq_refinement = Modulate(dim, dtype)
        self.param_alpha = nn.Parameter(torch.zeros(dim))
        self.param_beta = nn.Parameter(torch.ones(dim))

    def forward(self, img, y):
        b, _, h, w = y.shape
        xa = self.aux_conv(resize_bilinear(img.float(), h, w).to(img.dtype))
        thr = self.rate_adaptive_conv(xa.mean(dim=(2, 3), keepdim=True))
        thr = torch.sigmoid(thr).reshape(b, 2)
        high, low = frequency_bands(xa, thr[:, 0], thr[:, 1], self.segments,
                                    y.dtype)
        # the reference's naming: the layer named "low" takes the HIGH band
        fh = self.cross_layer_low(high, y)
        fl = self.cross_layer_high(low, y)
        out = self.cross_layer_agg(y, self.freq_refinement(fl, fh))
        return (out * self.param_alpha[:, None, None]
                + y * self.param_beta[:, None, None])


@register_model("measnet")
class MEASNet(BlockStackMixin, nn.Module):
    """Takes and returns NCHW; the output is fp32, and ``(out, {"aux_loss":
    ...})`` with ``train``. MEASNet's Downsample and Upsample
    (MEASNet.py:13-24) are the Restormer ones of ``ops/resample.py``: the
    same bias-free 3x3 conv and pixel (un)shuffle."""

    uses_moe_rng = True

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 4, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, use_bias: bool = False,
                 ln_type: str = "WithBias", atom_num: int = 32,
                 atom_dim: int = 256, fused_block: bool = False,
                 fused_attn: bool = False, fused_gdfn: bool = False,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self._init_blocks(ffn_expansion_factor, use_bias, ln_type,
                          fused_block, fused_attn, fused_gdfn, dtype)
        d, nb, r = dim, num_blocks, ffn_expansion_factor
        self.task_prompt = Taskprompt(atom_num, atom_dim, inp_channels, dtype)
        self.patch_embed = OverlapPatchEmbed(inp_channels, d, dtype)
        self.stpg_g_mese1 = STPG_G_MESE(atom_dim, d, r, dtype)
        self.encoder_level1 = self._stack(d, heads[0], nb[0])
        self.down1_2 = Downsample(d, dtype)
        # feed only the training balance loss: run in training alone
        self.stpg_g_mese2 = STPG_G_MESE(atom_dim, d * 2, r, dtype)
        self.encoder_level2 = self._stack(d * 2, heads[1], nb[1])
        self.down2_3 = Downsample(d * 2, dtype)
        self.stpg_g_mese3 = STPG_G_MESE(atom_dim, d * 4, r, dtype)
        self.encoder_level3 = self._stack(d * 4, heads[2], nb[2])
        self.down3_4 = Downsample(d * 4, dtype)
        self.latent = self._stack(d * 8, heads[3], nb[3])
        self.block1 = FreqBlock(d * 8, heads[2], use_bias,
                                inp_channels=inp_channels, dtype=dtype)
        self.up4_3 = Upsample(d * 8, dtype)
        self.reduce_chan_level3 = Conv(d * 8, d * 4, 1, bias=use_bias,
                                       dtype=dtype)
        self.fe_mee1 = FD_MEE(d * 4, dtype=dtype)
        self.decoder_level3 = self._stack(d * 4, heads[2], nb[2])
        self.block2 = FreqBlock(d * 4, heads[2], use_bias,
                                inp_channels=inp_channels, dtype=dtype)
        self.up3_2 = Upsample(d * 4, dtype)
        self.reduce_chan_level2 = Conv(d * 4, d * 2, 1, bias=use_bias,
                                       dtype=dtype)
        self.fe_mee2 = FD_MEE(d * 2, dtype=dtype)
        self.decoder_level2 = self._stack(d * 2, heads[1], nb[1])
        self.block3 = FreqBlock(d * 2, heads[2], use_bias,
                                inp_channels=inp_channels, dtype=dtype)
        self.up2_1 = Upsample(d * 2, dtype)
        self.fe_mee3 = FD_MEE(d * 2, dtype=dtype)
        self.decoder_level1 = self._stack(d * 2, heads[0], nb[0])
        self.refinement = self._stack(d * 2, heads[0], num_refinement_blocks)
        self.output = Conv(d * 2, out_channels, 3, padding=1, bias=use_bias,
                           dtype=dtype)

    def forward(self, inp_img, train=False, generator=None):
        x = inp_img if self.dtype is None else inp_img.to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        prompt = self.task_prompt(x)
        harm1 = self.stpg_g_mese1(self.patch_embed(x), prompt, train,
                                  generator)
        if train:
            harm1, aux = harm1
        enc1 = self._level(harm1, self.encoder_level1)
        x2 = self.down1_2(enc1)
        if train:
            aux = aux + self.stpg_g_mese2(x2, prompt, True, generator)[1]
        enc2 = self._level(x2, self.encoder_level2)
        x3 = self.down2_3(enc2)
        if train:
            aux = aux + self.stpg_g_mese3(x3, prompt, True, generator)[1]
        enc3 = self._level(x3, self.encoder_level3)
        latent = self._level(self.down3_4(enc3), self.latent)
        latent = self.block1(x, latent)

        dec3 = torch.cat([self.up4_3(latent), enc3], dim=1)
        dec3 = self.fe_mee1(self.reduce_chan_level3(dec3), train)
        dec3 = self.block2(x, self._level(dec3, self.decoder_level3))
        dec2 = torch.cat([self.up3_2(dec3), enc2], dim=1)
        dec2 = self.fe_mee2(self.reduce_chan_level2(dec2), train)
        dec2 = self.block3(x, self._level(dec2, self.decoder_level2))
        dec1 = self.fe_mee3(torch.cat([self.up2_1(dec2), enc1], dim=1),
                            train)
        dec1 = self._level(dec1, self.decoder_level1, self.refinement)
        out = (self.output(dec1) + x).float()
        if train:
            return out, {"aux_loss": aux}
        return out
