"""SFSNiD, HiLo and PINN (demo and side-project models;
image_restoration_tpu/models/demo_models.py), NCHW.

* :class:`SFSNiD` (demo/SFSNiD.py:433-522, nighttime dehazing): a MIMO
  U-Net of :class:`SFSTransformerBlock`\\ s. Each block's attention
  filters Q, K and V through :class:`FreqPath` (an SE-gated 1x1 pair on the
  fp32 rfft2's magnitude and phase, residual in each domain), attends in
  reflect-padded 8x8 windows with a continuous log-relative position bias
  (:class:`WindowAttentionCRPB`) and adds a reflect-padded 5x5 depthwise
  conv of V; a dual-domain block (a conv ResBlock beside the spectrum SE)
  follows. Instance-normed SCM stems take the half- and quarter-scale
  inputs, and ``train=True`` returns the three deep-supervision outputs
  (1/4, 1/2, full), ``train=False`` the full-size one.
* :class:`HiLo` (demo/hilo(高低频注意力).py, LITv2's intended NHWC window
  semantics, as the JAX module implements them): ``alpha`` of the heads
  attend from every pixel to the ``window_size``-pooled map, the rest
  within ``window_size`` windows. It maps ``in_dim`` channels to ``dim``,
  so it is an attention layer, not an image model: the CLIs refuse it and
  it runs at model level.
* :class:`PINNRestoration` (PINN_Image_Restoration/model.py:38-64): a
  residual CNN with a sigmoid head; its gradient-smoothness prior is
  ``train/losses.py`` ``grad_smooth``.

No Pallas kernel lies behind these models in JAX, and they run in plain
torch here. Parameters stay fp32 and ``dtype`` is the compute dtype, with
fp32 islands where JAX has them (the FFTs, the attention logits and
softmax, the LayerNorm's promoted output, the instance norm). Attribute
paths are the reference's (``Encoder.0.layers.1.fft_transformer_block.
attn.V.0.frequency_process.processmag.2.fc.0.weight``), which
:func:`sfsnid_key_map` flattens onto the JAX tree.

Hazards, where they apply:

* SE hidden width (:class:`SELayer`): ``channel // 16`` units, 0 below 16
  channels, where the SE gate here (and in the reference) is a constant
  0.5, and where flax cannot build the layer (its initializer divides by
  the zero fan-out); SFSNiD's narrowest SE has ``base_channel`` channels,
  so the JAX model needs ``base_channel`` 16 or more.
* Phase branches (:class:`FreqSpectrumSE`): a 1x1 conv of ``angle(rfft2)``.
  A real negative coefficient's angle is +pi or -pi by the sign of the
  rounding noise in its imaginary part, which differs between FFT
  libraries, so two packages agree there only on maps whose real
  coefficients are exactly real (power-of-two sides on the CPU; odd
  sides with a positive DC). The same holds for any coefficient whose
  imaginary part is within rounding of 0 while its real part is
  negative: the angle jumps by 2 pi across the negative real axis, the
  branch's 1x1 convs turn that jump into a change of every channel's
  phase at that frequency, and the next blocks carry it on. At the init
  two fp32 runs part there (a 1e-7 change of the input moves the output
  by ~0.3 relative; the card's forward and the CPU's differ by as much;
  JAX's fp32 output lies as far from its float64 one), while in float64
  the port's output is JAX's (tools/sfsnid_branch_cut.py,
  tests/sfsnid_conditioning.py). The magnitude and phase come
  from ``ops/fft.py`` ``_polar``: JAX's values, and at a zero coefficient
  the reference's gradient 0 where JAX's is NaN.
* Small maps (:class:`SFSAttention`): the window pad (up to 7) and the
  depthwise pad (2) can reach past a side of 2 or less; ``jnp.pad``
  reflects periodically there and so does ``ops/common.py``
  ``reflect_pad``, where ``F.pad`` raises.
* HiLo's windows need H and W to be multiples of ``window_size``: a
  ``ValueError`` names it where JAX's reshape fails.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.models.transweather import ConvTranspose
from image_restoration_tpu_torch.ops.common import Conv, Linear, reflect_pad
from image_restoration_tpu_torch.ops.fft import _polar, irfft2, rfft2
from image_restoration_tpu_torch.ops.layernorm import PromotingLayerNorm


# ------------------------------------------------------------------ SFSNiD --


def _log_relative_positions(ws: int) -> np.ndarray:
    """(N, N, 2) sign(d) * log(1 + |d|) of every window pair's (dy, dx),
    N = ws^2 (SFSNiD.py:23-34)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.float32)
    return np.sign(rel) * np.log1p(np.abs(rel))


class SELayer(nn.Module):
    """Squeeze-excite (SFSNiD.py:234-249): GAP, a bias-free Linear to
    ``channel // reduction`` units, ReLU, a bias-free Linear back,
    sigmoid, scale. With no hidden unit (``channel < reduction``) the gate
    is sigmoid(0) = 0.5 everywhere."""

    def __init__(self, channel: int, reduction: int = 16, dtype=None):
        super().__init__()
        hidden = channel // reduction
        self.fc = nn.Sequential(
            Linear(channel, hidden, bias=False, dtype=dtype), nn.ReLU(),
            Linear(hidden, channel, bias=False, dtype=dtype), nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean((2, 3)))[:, :, None, None]


def _spectrum_branch(nc, dtype):
    """1x1, leaky ReLU 0.1, SE, 1x1: the reference's Sequential."""
    return nn.Sequential(Conv(nc, nc, 1, dtype=dtype), nn.LeakyReLU(0.1),
                         SELayer(nc, dtype=dtype),
                         Conv(nc, nc, 1, dtype=dtype))


class FreqSpectrumSE(nn.Module):
    """Frequency_Spectrum_Dynamic_Aggregation (SFSNiD.py:252-277): of a
    complex spectrum, the magnitude and the phase each plus its branch's
    output (fp32 plus the compute dtype: fp32), recombined."""

    def __init__(self, nc: int, dtype=None):
        super().__init__()
        self.processmag = _spectrum_branch(nc, dtype)
        self.processpha = _spectrum_branch(nc, dtype)

    def forward(self, z):
        mag, pha = _polar(z.real, z.imag)
        mag = mag + self.processmag(mag)
        pha = pha + self.processpha(pha)
        return torch.complex(mag * torch.cos(pha), mag * torch.sin(pha))


class FreqPath(nn.Module):
    """BidomainNonlinearMapping_SinglePath (SFSNiD.py:301-314): the fp32
    rfft2 through :class:`FreqSpectrumSE`, back in x's dtype, plus x."""

    def __init__(self, nc: int, dtype=None):
        super().__init__()
        self.frequency_process = FreqSpectrumSE(nc, dtype)

    def forward(self, x):
        z = self.frequency_process(rfft2(x))
        return irfft2(z, x.shape[-2:], dtype=x.dtype) + x


class BasicConv(nn.Module):
    """SFSNiD.py:321-343: a biased conv (padding kernel // 2) or a
    transposed conv (padding kernel // 2 - 1), then exact GELU when
    ``relu``."""

    def __init__(self, in_channel: int, out_channel: int,
                 kernel_size: int = 3, stride: int = 1, relu: bool = True,
                 transpose: bool = False, dtype=None):
        super().__init__()
        if transpose:
            conv = ConvTranspose(in_channel, out_channel, kernel_size,
                                 stride, kernel_size // 2 - 1, dtype=dtype)
        else:
            conv = Conv(in_channel, out_channel, kernel_size, stride=stride,
                        padding=kernel_size // 2, dtype=dtype)
        self.main = nn.Sequential(conv, nn.GELU()) if relu else \
            nn.Sequential(conv)

    def forward(self, x):
        return self.main(x)


class ResBlockConv(nn.Module):
    """ResBlock_Conv (SFSNiD.py:210-221): conv1 (GELU), trans_layer,
    conv2, plus x."""

    def __init__(self, nc: int, dtype=None):
        super().__init__()
        self.conv1 = BasicConv(nc, nc, 3, relu=True, dtype=dtype)
        self.trans_layer = BasicConv(nc, nc, 3, relu=False, dtype=dtype)
        self.conv2 = BasicConv(nc, nc, 3, relu=False, dtype=dtype)

    def forward(self, x):
        return self.conv2(self.trans_layer(self.conv1(x))) + x


class WindowAttentionCRPB(nn.Module):
    """Window attention with a continuous relative position bias
    (SFSNiD.py:37-73) on (windows, N, 3C) q | k | v: the bias is an MLP
    (Linear 2->256, ReLU, Linear -> heads) of the log-relative positions;
    q scaled by head_dim^-0.5 in the compute dtype, fp32 logits plus the
    bias, fp32 softmax rounded to v's dtype, A.v accumulated in fp32 and
    rounded. The positions are a non-persistent buffer: the reference's
    ``relative_positions`` has no JAX leaf, and :func:`sfsnid_key_map`
    drops it."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 dtype=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.meta = nn.Sequential(Linear(2, 256, dtype=dtype), nn.ReLU(),
                                  Linear(256, num_heads, dtype=dtype))
        self.register_buffer("relative_positions", torch.from_numpy(
            _log_relative_positions(window_size)), persistent=False)

    def forward(self, qkv):
        bw, n, _ = qkv.shape
        heads = self.num_heads
        hd = self.dim // heads
        t = qkv.reshape(bw, n, 3, heads, hd)
        q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
        bias = self.meta(self.relative_positions).permute(2, 0, 1)
        attn = torch.einsum("bnhd,bmhd->bhnm", (q * hd ** -0.5).float(),
                            k.float())
        attn = torch.softmax(attn + bias[None].float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.float(), v.float())
        return out.to(v.dtype).reshape(bw, n, self.dim)


class SFSAttention(nn.Module):
    """Attention (SFSNiD.py:76-174): V, Q and K each a :class:`FreqPath`
    and a 1x1; q | k | v reflect-padded to whole windows (shifted by
    ``shift_size`` when it is not 0), window attention, cropped back; plus
    the 5x5 depthwise conv of V over a reflect pad of 2 (``conv_type``
    "DWConv"), then a 1x1."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 8,
                 shift_size: int = 0, conv_type: str = "DWConv", dtype=None):
        super().__init__()
        self.dim, self.window_size, self.shift_size = dim, window_size, \
            shift_size
        self.conv_type = conv_type

        def vqk():
            return nn.Sequential(FreqPath(dim, dtype),
                                 Conv(dim, dim, 1, dtype=dtype))

        self.V, self.Q, self.K = vqk(), vqk(), vqk()
        self.attn = WindowAttentionCRPB(dim, window_size, num_heads, dtype)
        if conv_type == "DWConv":
            self.conv = Conv(dim, dim, 5, groups=dim, dtype=dtype)
        self.proj = Conv(dim, dim, 1, dtype=dtype)

    def _pads(self, h, w):
        """(top, bottom, left, right) of the window pad."""
        ws, ss = self.window_size, self.shift_size
        mph, mpw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ss > 0:
            return ss, (ws - ss + mph) % ws, ss, (ws - ss + mpw) % ws
        return 0, mph, 0, mpw

    def forward(self, x):
        b, c, h, w = x.shape
        ws = self.window_size
        V = self.V(x)
        qkv = torch.cat([self.Q(x), self.K(x), V], dim=1)
        pt, pb, pl, pr = self._pads(h, w)
        qkv = reflect_pad(qkv, (pl, pr, pt, pb))
        ht, wt = qkv.shape[-2:]
        hg, wg = ht // ws, wt // ws
        win = qkv.reshape(b, 3 * c, hg, ws, wg, ws).permute(0, 2, 4, 3, 5, 1)
        out = self.attn(win.reshape(-1, ws * ws, 3 * c))
        out = out.reshape(b, hg, wg, ws, ws, c).permute(0, 5, 1, 3, 2, 4)
        out = out.reshape(b, c, ht, wt)[:, :, pt: pt + h, pl: pl + w]
        if self.conv_type == "DWConv":
            out = out + self.conv(reflect_pad(V, (2, 2, 2, 2)))
        return self.proj(out)


class SFSTransformerBlock(nn.Module):
    """TransformerBlock (SFSNiD.py:177-207): flax's LayerNorm over the
    channels (its output fp32, promoted) into :class:`SFSAttention`, plus
    x; then BidomainNonlinearMapping (:280-298): a 1x1 of the conv
    ResBlock's output beside the fp32 rfft2 through the spectrum SE, plus
    x. The reference keeps the dual-domain block's parts under
    ``fft_block``."""

    def __init__(self, dim: int, num_heads: int = 2, window_size: int = 8,
                 shift_size: int = 0, dtype=None):
        super().__init__()
        self.norm1 = PromotingLayerNorm(dim)
        self.attn = SFSAttention(dim, num_heads, window_size, shift_size,
                                 dtype=dtype)
        self.fft_block = nn.ModuleDict({
            "spatial_process": nn.ModuleDict(
                {"block": ResBlockConv(dim, dtype)}),
            "frequency_process": FreqSpectrumSE(dim, dtype),
            "cat": Conv(2 * dim, dim, 1, dtype=dtype)})

    def forward(self, x):
        h = self.norm1(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        x = x + self.attn(h)
        fb = self.fft_block
        spatial = fb["spatial_process"]["block"](x)
        freq = irfft2(fb["frequency_process"](rfft2(x)), x.shape[-2:],
                      dtype=x.dtype)
        return x + fb["cat"](torch.cat([spatial, freq], dim=1))


class InstanceNorm(nn.Module):
    """torch ``InstanceNorm2d(affine=True)`` as the JAX module computes it:
    fp32 per-sample spatial statistics (biased variance, eps 1e-5), the
    affine in fp32, cast back to x's dtype."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean((2, 3), keepdim=True)
        var = xf.var((2, 3), unbiased=False, keepdim=True)
        y = (xf - mu) / torch.sqrt(var + 1e-5)
        return (y * self.weight[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


class SCM(nn.Module):
    """SCM_withFFT (SFSNiD.py:386-402): a 3x3 BasicConv from the image, a
    ResBlock, and an instance norm when ``instance_norm``."""

    def __init__(self, out_plane: int, instance_norm: bool = False,
                 in_plane: int = 3, dtype=None):
        super().__init__()
        self.main = nn.Sequential(
            BasicConv(in_plane, out_plane, 3, relu=True, dtype=dtype),
            ResBlockConv(out_plane, dtype))
        self.ins = InstanceNorm(out_plane) if instance_norm else None

    def forward(self, x):
        h = self.main(x)
        return h if self.ins is None else self.ins(h)


class ConvOut(nn.Module):
    """ConvOut_withFFT (SFSNiD.py:405-421): a ResBlock, then a 3x3 to
    three channels (GELU when ``relu``)."""

    def __init__(self, plane: int, relu: bool = False, dtype=None):
        super().__init__()
        self.main = nn.Sequential(ResBlockConv(plane, dtype),
                                  BasicConv(plane, 3, 3, relu=relu,
                                            dtype=dtype))

    def forward(self, x):
        return self.main(x)


class _Stage(nn.Module):
    """EBlock/DBlock: ``num_res`` blocks, each under the reference's
    ``layers.<i>.fft_transformer_block``."""

    def __init__(self, dim: int, num_res: int, dtype=None):
        super().__init__()
        self.layers = nn.Sequential(*[nn.ModuleDict(
            {"fft_transformer_block": SFSTransformerBlock(dim, dtype=dtype)})
            for _ in range(num_res)])

    def forward(self, x):
        for layer in self.layers:
            x = layer["fft_transformer_block"](x)
        return x


def sfsnid_key_map(key: str):
    """A reference (and this port's) key -> the path the JAX importer
    walks: the torch module paths it cannot navigate flattened, and the
    ``relative_positions`` buffer, which has no JAX leaf, dropped."""
    if key.endswith("relative_positions"):
        return None
    key = re.sub(r"(Encoder|Decoder)\.(\d+)\.layers\.(\d+)\."
                 r"fft_transformer_block\.",
                 r"\1_\2_layers_\3_fft_transformer_block.", key)
    key = key.replace("fft_block.spatial_process.block.",
                      "fft_block_spatial_process_block.")
    key = key.replace("fft_block.frequency_process.",
                      "fft_block_frequency_process.")
    key = key.replace("fft_block.cat.", "fft_block_cat.")
    key = key.replace("FeatureMerge1.merge.", "FeatureMerge1_merge.")
    key = key.replace("FeatureMerge2.merge.", "FeatureMerge2_merge.")
    return key


@register_model("sfsnid", key_map=sfsnid_key_map)
class SFSNiD(nn.Module):
    """SFSNiD.py:433-522: the MIMO U-Net nighttime dehazer. The half- and
    quarter-scale inputs are nearest 0.5x downsamples (every other pixel,
    ``F.interpolate``'s default); the outputs are fp32."""

    def __init__(self, num_res: int = 3, base_channel: int = 32, dtype=None):
        super().__init__()
        bc = base_channel
        self.dtype = dtype
        self.Encoder = nn.ModuleList([_Stage(c, num_res, dtype)
                                      for c in (bc, 2 * bc, 4 * bc)])
        self.feat_extract = nn.ModuleList([
            SCM(bc, False, dtype=dtype),
            BasicConv(bc, 2 * bc, 3, stride=2, relu=True, dtype=dtype),
            BasicConv(2 * bc, 4 * bc, 3, stride=2, relu=True, dtype=dtype),
            BasicConv(4 * bc, 2 * bc, 4, stride=2, relu=True, transpose=True,
                      dtype=dtype),
            BasicConv(2 * bc, bc, 4, stride=2, relu=True, transpose=True,
                      dtype=dtype),
            ConvOut(bc, dtype=dtype)])
        self.Decoder = nn.ModuleList([_Stage(c, num_res, dtype)
                                      for c in (4 * bc, 2 * bc, bc)])
        self.Convs = nn.ModuleList([
            BasicConv(4 * bc, 2 * bc, 1, relu=True, dtype=dtype),
            BasicConv(2 * bc, bc, 1, relu=True, dtype=dtype)])
        self.ConvsOut = nn.ModuleList([ConvOut(4 * bc, dtype=dtype),
                                       ConvOut(2 * bc, dtype=dtype)])
        self.FeatureMerge1 = nn.ModuleDict({"merge": BasicConv(
            8 * bc, 4 * bc, 3, relu=False, dtype=dtype)})
        self.FeatureMerge2 = nn.ModuleDict({"merge": BasicConv(
            4 * bc, 2 * bc, 3, relu=False, dtype=dtype)})
        self.SCM1 = SCM(4 * bc, True, dtype=dtype)
        self.SCM2 = SCM(2 * bc, True, dtype=dtype)

    def forward(self, x, train: bool = False):
        xc = x.to(self.dtype) if self.dtype is not None else x
        x2 = xc[:, :, ::2, ::2]
        x4 = x2[:, :, ::2, ::2]
        z2, z4 = self.SCM2(x2), self.SCM1(x4)
        fe = self.feat_extract
        res1 = self.Encoder[0](fe[0](xc))
        z = self.FeatureMerge2["merge"](torch.cat([fe[1](res1), z2], dim=1))
        res2 = self.Encoder[1](z)
        z = self.FeatureMerge1["merge"](torch.cat([fe[2](res2), z4], dim=1))
        z = self.Decoder[0](self.Encoder[2](z))
        out4 = self.ConvsOut[0](z)
        z = self.Convs[0](torch.cat([fe[3](z), res2], dim=1))
        z = self.Decoder[1](z)
        out2 = self.ConvsOut[1](z)
        z = self.Convs[1](torch.cat([fe[4](z), res1], dim=1))
        out1 = fe[5](self.Decoder[2](z))
        outs = [out4.float(), out2.float(), out1.float()]
        return outs if train else outs[2]


# -------------------------------------------------------------------- HiLo --


def _attend(q, k, v, scale):
    """softmax(q k^T * scale) v over (..., N, heads, hd) q and (..., M,
    heads, hd) k, v: q scaled in its dtype, fp32 logits and softmax
    rounded to v's dtype, A.v accumulated in fp32 and rounded."""
    attn = torch.einsum("...nhd,...mhd->...hnm", (q * scale).float(),
                        k.float())
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    return torch.einsum("...hnm,...mhd->...nhd", attn.float(),
                        v.float()).to(v.dtype)


@register_model("hilo")
class HiLo(nn.Module):
    """HiLo attention on an NCHW map of ``in_dim`` channels (``dim`` by
    default: inside a LITv2 stage; flax infers it from the input, 3 under
    the JAX CLIs' init), to ``dim`` channels: ``int(num_heads * alpha)``
    low-frequency heads (every pixel's query against the
    ``window_size``-average-pooled map's keys and values; the unpooled map
    at ``window_size`` 1, where every head is low) and the rest
    high-frequency (within non-overlapping ``window_size`` windows), their
    outputs each through a Linear and concatenated, high first. The
    windows need H and W to be multiples of ``window_size``."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 2,
                 alpha: float = 0.5, qkv_bias: bool = False, in_dim=None,
                 dtype=None):
        super().__init__()
        in_dim = dim if in_dim is None else in_dim
        self.head_dim = dim // num_heads
        self.l_heads = int(num_heads * alpha)
        self.h_heads = num_heads - self.l_heads
        self.ws = window_size
        if window_size == 1:
            self.l_heads, self.h_heads = num_heads, 0
        l_dim = self.l_heads * self.head_dim
        h_dim = self.h_heads * self.head_dim
        if self.h_heads > 0:
            self.h_qkv = Linear(in_dim, h_dim * 3, bias=qkv_bias, dtype=dtype)
            self.h_proj = Linear(h_dim, h_dim, dtype=dtype)
        if self.l_heads > 0:
            self.l_q = Linear(in_dim, l_dim, bias=qkv_bias, dtype=dtype)
            self.l_kv = Linear(in_dim, l_dim * 2, bias=qkv_bias, dtype=dtype)
            self.l_proj = Linear(l_dim, l_dim, dtype=dtype)

    def _hifi(self, x):
        b, h, w, c = x.shape
        ws, heads, hd = self.ws, self.h_heads, self.head_dim
        hg, wg = h // ws, w // ws
        xv = x.reshape(b, hg, ws, wg, ws, c).permute(0, 1, 3, 2, 4, 5)
        qkv = self.h_qkv(xv.reshape(b, hg * wg, ws * ws, c))
        qkv = qkv.reshape(b, hg * wg, ws * ws, 3, heads, hd)
        o = _attend(qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :],
                    hd ** -0.5)
        o = o.reshape(b, hg, wg, ws, ws, heads * hd).permute(0, 1, 3, 2, 4, 5)
        return self.h_proj(o.reshape(b, h, w, heads * hd))

    def _lofi(self, x, x_nchw):
        b, h, w, c = x.shape
        heads, hd = self.l_heads, self.head_dim
        q = self.l_q(x).reshape(b, h * w, heads, hd)
        if self.ws > 1:
            pooled = F.avg_pool2d(x_nchw, self.ws, self.ws)
            kvsrc = pooled.permute(0, 2, 3, 1).reshape(b, -1, c)
        else:
            kvsrc = x.reshape(b, -1, c)
        kv = self.l_kv(kvsrc).reshape(b, -1, 2, heads, hd)
        o = _attend(q, kv[:, :, 0], kv[:, :, 1], hd ** -0.5)
        return self.l_proj(o.reshape(b, h, w, heads * hd))

    def forward(self, x):
        _, _, h, w = x.shape
        if self.h_heads > 0 and (h % self.ws or w % self.ws):
            raise ValueError(f"HiLo: H and W ({h}x{w}) must be multiples of "
                             f"window_size {self.ws}")
        xl = x.permute(0, 2, 3, 1)
        outs = []
        if self.h_heads > 0:
            outs.append(self._hifi(xl))
        if self.l_heads > 0:
            outs.append(self._lofi(xl, x))
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        return out.permute(0, 3, 1, 2)


# -------------------------------------------------------------------- PINN --


class _PinnResBlock(nn.Module):
    """PINN_Image_Restoration/model.py:10-27: relu(conv2(relu(conv1(x)))
    + x), x through a 1x1 ``downsample`` when the widths differ."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__()
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1,
                          dtype=dtype)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1,
                          dtype=dtype)
        self.downsample = (Conv(in_channels, out_channels, 1, dtype=dtype)
                           if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(h + x)


@register_model("pinn")
class PINNRestoration(nn.Module):
    """ComplexCNNModel (PINN_Image_Restoration/model.py:38-64): the
    reference's ``encoder`` and ``decoder`` Sequentials (3x3 convs and
    residual blocks at 64 and 128 channels), a sigmoid head, fp32 out."""

    def __init__(self, dtype=None):
        super().__init__()

        def conv(a, b):
            return Conv(a, b, 3, padding=1, dtype=dtype)

        self.encoder = nn.Sequential(
            conv(3, 64), nn.ReLU(), _PinnResBlock(64, 64, dtype),
            _PinnResBlock(64, 128, dtype), conv(128, 128), nn.ReLU(),
            _PinnResBlock(128, 128, dtype))
        self.decoder = nn.Sequential(
            conv(128, 128), nn.ReLU(), _PinnResBlock(128, 128, dtype),
            _PinnResBlock(128, 64, dtype), conv(64, 3))

    def forward(self, x):
        return torch.sigmoid(self.decoder(self.encoder(x))).float()
