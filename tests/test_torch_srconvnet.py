"""The port's SRConvNet (``models/srconvnet.py``) and its Fourier ops
(``ops/fft.py``) against the JAX package's, on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``;
``layer_scale``, 1e-6 at init, which makes FConvMod's softmax over H*W
nearly uniform, is seeded to O(1) so the modulation reaches the output),
the tree goes into the port through ``state_dict_from_jax``, and both run
the same seeded numpy inputs in fp32 (JAX at "highest" matmul precision,
torch with TF32 off); the port takes NCHW, the JAX package NHWC. JAX runs
FourierUnit's FFT path (``use_matmul_dft=False``, what it takes off the
TPU).

Tolerance: rtol=1e-4, atol=1e-5 for every module; the whole model at
atol=1e-5 x the largest |output| (random weights give outputs near 10) and
rtol=1e-4. bf16: the port's bf16 output against JAX's fp32 within 3x the
JAX bf16 model's error against it (max and mean): the two bf16 models
round at different points (JAX at its pre-shuffle einsums and its padded
7x7 bank), so they are not held to each other bit for bit.

* ``ops/fft.py``: the channel interleave and its inverse, FourierUnit (an
  even and an odd width, grouped).
* FConvMod, KernelAttention, KernelAggregation and MixFFN on a batch of 2
  whose per-sample kernels differ (and MixFFN with one kernel: the plain
  depthwise branches).
* SRNet at x4 and x2, ``srconvnet_key_map``, bf16, and ``make_restore_fn``
  at a size the pad changes (the crop keeps 4x the input).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import ATOL, RTOL, init_shapes, load, nchw, nhwc, pair, randomized
from moe_parity import compiled

from image_restoration_tpu.models import srconvnet as js
from image_restoration_tpu.ops import fft as jfft
from image_restoration_tpu_torch.cli.infer import make_restore_fn
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import srconvnet as ts
from image_restoration_tpu_torch.ops import fft as tfft


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _x(rng, c, h=12, w=10, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


def test_channel_interleave():
    rng = np.random.default_rng(0)
    z = _x(rng, 4) + 1j * _x(rng, 4)
    want = np.asarray(jfft.complex_to_channels(jnp.asarray(z)))
    got = tfft.complex_to_channels(nchw(z))
    np.testing.assert_array_equal(nhwc(got), want)
    back = tfft.channels_to_complex(got)
    np.testing.assert_array_equal(back.numpy(), nchw(z).numpy())


@pytest.mark.parametrize("dim,groups,hw", [(8, 1, (12, 10)), (6, 2, (9, 7))])
def test_fourier_unit(dim, groups, hw):
    rng = np.random.default_rng(1)
    want, got = pair(jfft.FourierUnit(dim, groups, use_matmul_dft=False),
                     tfft.FourierUnit(dim, groups), rng, _x(rng, dim, *hw))
    _close(got, want)


def _seed_layer_scale(params, rng):
    """``layer_scale`` leaves (1e-6 at init) seeded in [0.5, 2]."""
    for k, v in params.items():
        if isinstance(v, dict):
            _seed_layer_scale(v, rng)
        elif k == "layer_scale":
            params[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return params


def _pair_seeded(jmod, tmod, rng, x, key_map=None):
    """``pair`` with the layer scales seeded."""
    params = _seed_layer_scale(
        randomized(init_shapes(jmod, x)["params"], rng), rng)
    load(tmod, params, key_map).eval()
    want = jmod.apply({"params": params}, x)
    with torch.no_grad():
        got = tmod(nchw(x))
    return want, got, params


def test_fconvmod():
    rng = np.random.default_rng(2)
    want, got, params = _pair_seeded(js.FConvMod(16, 4),
                                     ts.FConvMod(16, 4), rng, _x(rng, 16))
    assert np.abs(params["layer_scale"]).min() >= 0.5
    _close(got, want)


def test_kernel_attention():
    rng = np.random.default_rng(3)
    want, got = pair(js.KernelAttention(16, 4), ts.KernelAttention(16, 4),
                     rng, _x(rng, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


@pytest.mark.parametrize("groups", [16, 4])
def test_kernel_aggregation_per_sample(groups):
    """A batch of 2 with different attention rows: each sample convolves
    with its own kernel (the batch folded into the groups)."""
    rng = np.random.default_rng(4)
    x = _x(rng, 16)
    att = rng.random((2, 4)).astype(np.float32)
    jmod = js.KernelAggregation(16, 5, groups, 4)
    params = randomized(init_shapes(jmod, x, att)["params"], rng)
    tmod = load(ts.KernelAggregation(16, 5, groups, 4), params)
    want = jmod.apply({"params": params}, x, att)
    with torch.no_grad():
        got = tmod(nchw(x), torch.from_numpy(att))
        alone = tmod(nchw(x[1:]), torch.from_numpy(att[1:]))
    _close(got, want)
    np.testing.assert_allclose(got[1:].numpy(), alone.numpy(), RTOL, ATOL)


@pytest.mark.parametrize("num_kernels", [4, 1])
def test_mixffn(num_kernels):
    rng = np.random.default_rng(5)
    x = _x(rng, 16)
    x[1] = 2.0 * x[1] + 0.5  # another pooled mean: other per-sample kernels
    want, got = pair(js.MixFFN(16, num_kernels), ts.MixFFN(16, num_kernels),
                     rng, x)
    _close(got, want)


TINY = dict(dim=16, n_blocks=2, num_heads=2, num_kernels=4)


@functools.lru_cache(maxsize=None)
def _jax_model(scale, bf16=False):
    rng = np.random.default_rng(20 + scale)
    x = rng.random((2, 12, 10, 3), dtype=np.float32)
    jnet = js.SRNet(**TINY, scale=scale,
                    dtype=jnp.bfloat16 if bf16 else None)
    params = _seed_layer_scale(
        randomized(init_shapes(jnet, jnp.asarray(x))["params"], rng), rng)
    want = np.asarray(compiled(lambda p, a: jnet.apply({"params": p}, a),
                               params, jnp.asarray(x)), np.float32)
    return params, x, want


def _port(scale, params, dtype=None):
    return load(get_model("srconvnet", **TINY, scale=scale,
                          dtype=dtype).eval(), params, ts.srconvnet_key_map)


@pytest.mark.parametrize("scale", [4, 2])
def test_whole_model_matches_jax(scale):
    params, x, want = _jax_model(scale)
    with torch.inference_mode():
        got = _port(scale, params)(nchw(x))
    assert got.dtype == torch.float32
    assert got.shape == (2, 3, 12 * scale, 10 * scale)
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_key_map():
    assert ts.srconvnet_key_map("sub_mean.weight") is None
    assert ts.srconvnet_key_map("add_mean.bias") is None
    key = "blocks.0.ffn.conv1.aggregation.weight"
    assert ts.srconvnet_key_map(key) == js.srconvnet_key_map(key) == key


def test_bf16_within_three_times_jax_bf16():
    params, x, want32 = _jax_model(4)
    _, _, want16 = _jax_model(4, bf16=True)
    with torch.inference_mode():
        got = _port(4, params, torch.bfloat16)(nchw(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err_port = np.abs(nhwc(got) - want32)
    err_jax = np.abs(want16 - want32)
    assert err_port.max() <= 3 * err_jax.max(), (err_port.max(),
                                                 err_jax.max())
    assert err_port.mean() <= 3 * err_jax.mean(), (err_port.mean(),
                                                   err_jax.mean())


def test_restore_keeps_the_scale():
    """``make_restore_fn`` pads 13x11 to 16x16, the model returns 64x64 and
    the crop keeps 52x44, the model's output on the unpadded pixels."""
    params, _, _ = _jax_model(4)
    model = _port(4, params)
    img = np.random.default_rng(30).random((13, 11, 3), dtype=np.float32)
    cfg = {"model": "srconvnet", "model_kwargs": {"scale": 4},
           "pad_multiple": 8}
    out = make_restore_fn(cfg, model)(img)
    assert out.shape == (52, 44, 3)
    with torch.inference_mode():
        x = torch.from_numpy(img).permute(2, 0, 1)[None]
        direct = model(torch.nn.functional.pad(x, (0, 5, 0, 3),
                                               mode="reflect"))
    want = direct.clamp(0, 1)[0, :, :52, :44].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
