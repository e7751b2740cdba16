"""The port's MEASNet against the JAX package's, on the same weights (the
seeded trees of ``tests/family_parity.py``, and seeded BatchNorm running
statistics through the bridge's ``batch_stats``), fp32, JAX at "highest"
matmul precision and torch with TF32 off.

* The ops MEASNet brings: ``normalized_channel_logits_tok_minor``,
  ``GroupedConv`` (1xk and kx1, grouped and dense), ``LayerNorm2d`` and
  ``layer_scale_init``; ``topk_lower_index`` against ``jax.lax.top_k`` on
  rows full of ties (equal indices).
* Modules (Taskprompt, _Mlp, TokenMoE, STPG_G_MESE, FD, StripedConv2d,
  _WET, MESE, MEE, FD_MEE, CrossAttention, _SpatialGate, _ChannelGate,
  Modulate, FreqBlock with and without a low band, Downsample, Upsample):
  rtol=1e-4, atol=1e-5. TokenMoE and STPG_G_MESE are held on their
  output; the JAX balance loss has no port counterpart (eval only).
* The whole model at dim 8, one block a level, 256x256, plain and
  ``fused_block``, against the JAX model: atol=2e-4. At 256x256 block3
  runs at 128x128, whose low band is empty unless its rate gate
  saturates, so the test saturates it and checks the band is not empty;
  the seed is one at which no top-k pick is within 1e-6 of a tie (the
  logits' fp32 rounding is ~1e-7).
* A JAX ``.npz`` through ``load_params`` (params only: BatchNorm
  statistics stay at the init, as in JAX).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    ATOL,
    RTOL,
    init_shapes,
    load,
    nchw,
    nhwc,
    pair,
    randomized,
)

from image_restoration_tpu.models import measnet as jm
from image_restoration_tpu.ops import attention as jatt
from image_restoration_tpu.ops import common as jcommon
from image_restoration_tpu.ops import layernorm as jln
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.models import adair as ta
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import measnet as tm
from image_restoration_tpu_torch.ops import attention as tatt
from image_restoration_tpu_torch.ops import common as tcommon
from image_restoration_tpu_torch.ops import layernorm as tln
from image_restoration_tpu_torch.ops import resample as tres

TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
            heads=(1, 2, 4, 8))


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _stats(shapes, rng):
    """Seeded BatchNorm running statistics: means near 0, variances in
    [0.5, ~3]."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                z = rng.standard_normal(v.shape)
                z = 0.1 * z if k == "running_mean" else 0.5 + np.abs(z)
                out[k] = z.astype(np.float32)
        return out
    return walk(shapes)


def _to_torch(x):
    return nchw(x) if x.ndim == 4 else torch.from_numpy(np.asarray(x))


def _close(got, want):
    got = list(got) if isinstance(got, tuple) else [got]
    want = list(want) if isinstance(want, tuple) else [want]
    for g, w in zip(got, want):
        g = nhwc(g) if g.ndim == 4 else g.detach().numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


def _x(rng, c, h=12, w=16, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


def _pair(jmod, tmod, seed, *inputs):
    rng = np.random.default_rng(seed)
    return pair(jmod, tmod, rng, *inputs, to_torch=_to_torch,
                batch_stats=_stats)


# ------------------------------------------------------------------ ops ----

def test_normalized_channel_logits_tok_minor():
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((2, 3, 8, 40)).astype(np.float32)
            for _ in range(2))
    q[0, 0, 1] = 0.0  # a zero channel: the eps clamp
    want = jatt.normalized_channel_logits_tok_minor(jnp.asarray(q),
                                                    jnp.asarray(k))
    got = tatt.normalized_channel_logits_tok_minor(torch.from_numpy(q),
                                                   torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("ksize,groups", [((1, 3), 8), ((3, 1), 8),
                                          ((1, 5), 1), ((3, 1), 2)])
def test_grouped_conv(ksize, groups):
    pad = tuple(k // 2 for k in ksize)
    rng = np.random.default_rng(1)
    want, got = pair(
        jcommon.GroupedConv(8, ksize, padding=[(p, p) for p in pad],
                            feature_group_count=groups),
        tcommon.GroupedConv(8, 8, ksize, pad, groups), rng, _x(rng, 8))
    _close(got, want)


def test_layer_norm_2d():
    rng = np.random.default_rng(2)
    want, got = pair(jln.LayerNorm2d(), tln.LayerNorm2d(16), rng,
                     _x(rng, 16) * 3 + 1)
    _close(got, want)


def test_layer_scale_init():
    want = jcommon.layer_scale_init(1e-6)(jax.random.PRNGKey(0), (4, 1, 1))
    got = tcommon.layer_scale_init(1e-6)((4, 1, 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_lower_index_keeps_the_lower_index_on_ties():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 3, (64, 6)).astype(np.float32)  # ties in every row
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = tm.topk_lower_index(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# -------------------------------------------------------------- modules ----

def test_taskprompt():
    img = np.random.default_rng(4).random((2, 40, 36, 3), dtype=np.float32)
    want, got = _pair(jm.Taskprompt(16, 32), tm.Taskprompt(16, 32), 4, img)
    _close(got, want)


def test_mlp():
    x = np.random.default_rng(5).standard_normal((50, 16)).astype(np.float32)
    want, got = _pair(jm._Mlp(24, 16), tm._Mlp(16, 24, 16), 5, x)
    _close(got, want)


def test_token_moe():
    rng = np.random.default_rng(6)
    want, got = _pair(jm.TokenMoE(16, 2.66), tm.TokenMoE(16, 2.66), 6,
                      _x(rng, 16), rng.standard_normal((2, 16)).astype(
                          np.float32))
    _close(got, want[0])


def test_stpg_g_mese():
    rng = np.random.default_rng(7)
    want, got = _pair(jm.STPG_G_MESE(32, 16, 2.66),
                      tm.STPG_G_MESE(32, 16, 2.66), 7, _x(rng, 16),
                      rng.standard_normal((2, 32)).astype(np.float32))
    _close(got, want[0])


def test_fd():
    rng = np.random.default_rng(8)
    want, got = _pair(jm.FD(16), tm.FD(16), 8, _x(rng, 16))
    _close(got, want)


def test_striped_conv():
    rng = np.random.default_rng(9)
    want, got = _pair(jm.StripedConv2d(16), tm.StripedConv2d(16), 9,
                      _x(rng, 16))
    _close(got, want)


def test_wet():
    rng = np.random.default_rng(10)
    want, got = _pair(jm._WET(5), tm._WET(16, 5), 10,
                      rng.standard_normal((2, 16)).astype(np.float32))
    _close(got, want)


@pytest.mark.parametrize("name", ["MESE", "MEE", "FD_MEE"])
def test_expert_mixtures(name):
    """At 32x32 the recursive stride-4 calibration reaches 2x2."""
    rng = np.random.default_rng(11)
    x = _x(rng, 16, 32, 32)
    want, got = _pair(getattr(jm, name)(16), getattr(tm, name)(16), 11, x)
    _close(got, want)


@pytest.mark.parametrize("heads,bias", [(2, False), (4, True)])
def test_cross_attention(heads, bias):
    rng = np.random.default_rng(12)
    want, got = _pair(jm.CrossAttention(16, heads, bias),
                      tm.CrossAttention(16, heads, bias), 12, _x(rng, 16),
                      _x(rng, 16))
    _close(got, want)


@pytest.mark.parametrize("name", ["_SpatialGate", "_ChannelGate"])
def test_gates(name):
    rng = np.random.default_rng(13)
    args = () if name == "_SpatialGate" else (32,)
    want, got = _pair(getattr(jm, name)(*args), getattr(tm, name)(*args), 13,
                      _x(rng, 32))
    _close(got, want)


def test_modulate():
    rng = np.random.default_rng(14)
    want, got = _pair(jm.Modulate(32), tm.Modulate(32), 14, _x(rng, 32),
                      _x(rng, 32))
    _close(got, want)


@pytest.mark.parametrize("segments", [128, 8])
def test_freq_block(segments):
    """segments 8 at 32x24: half-extents floor(4 * frac) and floor(3 *
    frac), a low band for the seeded gate; at 128 it is empty."""
    rng = np.random.default_rng(15)
    img = rng.random((2, 64, 48, 3), dtype=np.float32)
    jmod = jm.FreqBlock(16, 4, segments=segments)
    tmod = tm.FreqBlock(16, 4, segments=segments)
    rates = []
    tmod.rate_adaptive_conv.register_forward_hook(
        lambda m, i, o: rates.append(o))
    want, got = _pair(jmod, tmod, 15, img, _x(rng, 16, 32, 24))
    thr = torch.sigmoid(rates[0].reshape(2, 2))
    band = ta.adaptive_rect_mask(32, 24, thr[:, 0], thr[:, 1], segments)
    assert (band.sum() > 0) == (segments == 8)
    _close(got, want)


@pytest.mark.parametrize("name", ["Downsample", "Upsample"])
def test_resamplers_are_the_restormer_ones(name):
    rng = np.random.default_rng(16)
    want, got = _pair(getattr(jm, name)(16), getattr(tres, name)(16), 16,
                      _x(rng, 16))
    _close(got, want)


# ---------------------------------------------------------- whole model ----

def _saturate_rate_gate(tree, name):
    """Weights of ``name``'s rate gate that drive both logits to about
    +1000 * |mean feature| (tests/test_torch_adair.py): the sigmoid is
    exactly 1.0 in fp32 and the band's half-extent floor(h // 128)."""
    k0 = tree[name]["rate_adaptive_conv_0"]["conv"]["kernel"]
    c = k0.shape[2]
    k0 = np.zeros_like(k0)
    k0[..., 0], k0[..., 1] = 100.0 / c, -100.0 / c
    tree[name]["rate_adaptive_conv_0"]["conv"]["kernel"] = k0
    k2 = tree[name]["rate_adaptive_conv_2"]["conv"]["kernel"]
    tree[name]["rate_adaptive_conv_2"]["conv"]["kernel"] = np.full_like(
        k2, 1000.0)


@functools.lru_cache(maxsize=None)
def _jax_model():
    rng = np.random.default_rng(17)
    x = rng.random((1, 256, 256, 3), dtype=np.float32)
    jnet = jm.MEASNet(**TINY)
    shapes = init_shapes(jnet, jnp.asarray(x))
    params = randomized(shapes["params"], rng)
    _saturate_rate_gate(params, "block3")
    stats = _stats(shapes["batch_stats"], rng)
    variables = {"params": params, "batch_stats": stats}
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, a: jnet.apply(v, a))(
            variables, jnp.asarray(x)))
    return params, stats, x, want


def _margin(values, k):
    """The least gap between the k-th and the (k+1)-th largest entries."""
    top = torch.sort(values, dim=-1, descending=True).values
    return (top[..., k - 1] - top[..., k]).min().item()


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_whole_model_matches_jax(fused):
    params, stats, x, want = _jax_model()
    tnet = load(get_model("measnet", **TINY, fused_block=fused).eval(),
                params, batch_stats=stats)
    seen = {"moe": [], "mese": [], "rate": []}
    moe = tnet.stpg_g_mese1.model
    moe.register_forward_pre_hook(lambda m, a: seen["moe"].append(
        torch.cat([tm._nhwc(a[0]).reshape(-1, a[0].shape[1]),
                   a[1].expand(a[0].shape[-2] * a[0].shape[-1], -1)],
                  dim=-1) @ m.w_g))
    for m in tnet.modules():
        if isinstance(m, tm._WET):
            m.register_forward_hook(lambda m, i, o: seen["mese"].append(
                torch.softmax(o.float(), dim=-1)))
    tnet.block3.rate_adaptive_conv.register_forward_hook(
        lambda m, i, o: seen["rate"].append(o))
    with torch.inference_mode():
        got = tnet(nchw(x))
    assert got.dtype == torch.float32
    assert _margin(seen["moe"][0], 2) > 1e-6
    assert min(_margin(w, 2) for w in seen["mese"]) > 1e-6
    thr = torch.sigmoid(seen["rate"][0].reshape(1, 2))
    assert ta.adaptive_rect_mask(128, 128, thr[:, 0], thr[:, 1]).sum() == 4
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=2e-4)


def test_npz_checkpoint_loads(tmp_path):
    params, _, _, _ = _jax_model()
    path = str(tmp_path / "measnet.npz")
    save_params_npz(path, params)
    fresh = get_model("measnet", **TINY)
    model = load_params({"model": "measnet", "ckpt": path},
                        get_model("measnet", **TINY))
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["fe_mee2.high_block.block.experts.3.conv_2.weight"].numpy(),
        params["fe_mee2"]["high_block"]["block"]["experts_3"]["conv_2"][
            "conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["stpg_g_mese3.model.w_g"].numpy(),
        params["stpg_g_mese3"]["model"]["w_g"])
    assert torch.equal(sd["fe_mee1.spilit.bn.running_var"],
                       fresh.state_dict()["fe_mee1.spilit.bn.running_var"])
