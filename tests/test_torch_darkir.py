"""The port's DarkIR (``models/darkir.py``) and ``ops/fft.py``'s FreMLP
against the JAX package's, on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``;
the zero-initialised ``beta``/``gamma`` are random too, so every branch
reaches the output), the tree goes into the port through
``state_dict_from_jax``, and both run the same seeded numpy inputs in fp32
(JAX at "highest" matmul precision, torch with TF32 off); the port takes
NCHW, the JAX package NHWC.

Tolerance: rtol=1e-4, atol=1e-5 for every module; the whole model at
atol=1e-5 x the largest |output| (random weights give outputs near 40)
and rtol=1e-4. bf16: the port's bf16 output against JAX's fp32 within 3x
the JAX bf16 model's error against it (max and mean).

* FreMLP (an even and an odd size); its gradients where rfft2
  coefficients are exactly 0 (constant channels): JAX's sqrt/atan2 give
  NaN there, the port's ``_polar`` gives the reference's ``torch.abs`` /
  ``torch.angle`` gradient, also through a whole EBlock.
* EBlock (one dilation, with and without the extra depthwise conv),
  DBlock (dilations 1/4/9, the extra conv at groups=c over 2c channels).
* DarkIR (a narrow configuration) at 30x21, which pads to 32x24, with and
  without ``side_loss``; ``darkir_key_map`` (``modules_list``,
  ``side_out``); bf16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import ATOL, RTOL, init_shapes, load, nchw, nhwc, pair, randomized
from moe_parity import compiled

from image_restoration_tpu.models import darkir as jd
from image_restoration_tpu.ops import fft as jfft
from image_restoration_tpu_torch.models import darkir as td
from image_restoration_tpu_torch.models import get_model
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


@pytest.mark.parametrize("hw", [(12, 10), (9, 11)])
def test_fre_mlp(hw):
    rng = np.random.default_rng(0)
    want, got = pair(jfft.FreMLP(8), tfft.FreMLP(8), rng, _x(rng, 8, *hw))
    _close(got, want)


def _reference_fre_mlp(mod, x):
    """The reference's FreMLP (``torch.abs`` and ``torch.angle`` of the
    rfft2 coefficients) with the port module's weights."""
    z = torch.fft.rfft2(x, norm="backward")
    m, pha = mod.process1(torch.abs(z)), torch.angle(z)
    return torch.fft.irfft2(torch.complex(m * torch.cos(pha),
                                          m * torch.sin(pha)),
                            s=x.shape[-2:], norm="backward")


def _grads(fn, params, x, cot):
    xt = nchw(x).requires_grad_()
    for p in params:
        p.grad = None
    (fn(xt) * nchw(cot)).sum().backward()
    return [xt.grad] + [p.grad.clone() for p in params]


def test_fre_mlp_gradient_at_zero_coefficients():
    """Constant channels of a 4x4 map: every rfft2 coefficient but the
    mean is 0 there. The port's gradients are finite and equal the
    reference formulation's; JAX's input gradient is NaN."""
    rng = np.random.default_rng(1)
    x = _x(rng, 8, 4, 4)
    x[..., :4] = 0.5
    cot = _x(rng, 8, 4, 4)
    jmod = jfft.FreMLP(8)
    params = randomized(init_shapes(jmod, x)["params"], rng)
    tmod = load(tfft.FreMLP(8), params)
    got = _grads(tmod, list(tmod.parameters()), x, cot)
    want = _grads(lambda a: _reference_fre_mlp(tmod, a),
                  list(tmod.parameters()), x, cot)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), RTOL,
                                   ATOL * float(w.abs().max()))
    jgrad = jax.grad(lambda a: jnp.sum(jmod.apply({"params": params}, a)
                                       * cot))(x)
    assert np.isnan(np.asarray(jgrad)).any()


def test_eblock_gradient_at_zero_coefficients():
    """The same through a whole EBlock at its init's ``beta`` of 0 (the
    gated branch does not reach FreMLP's input): an input constant over
    the image in each channel gives FreMLP a normed map with constant
    channels, whose rfft2 coefficients but the mean are 0. Every gradient
    of the port is finite; some of JAX's are NaN."""
    rng = np.random.default_rng(2)
    x = np.broadcast_to(rng.standard_normal(8), (1, 4, 4, 8)).astype(
        np.float32)
    jmod = jd.EBlock(8, extra_depth_wise=False)
    params = randomized(init_shapes(jmod, x)["params"], rng)
    params["beta"] = np.zeros_like(params["beta"])
    tmod = load(td.EBlock(8, extra_depth_wise=False), params)
    grads = _grads(tmod, list(tmod.parameters()), x, np.ones_like(x))
    assert all(torch.isfinite(g).all() for g in grads)
    jgrad = compiled(jax.grad(lambda p: jnp.sum(jmod.apply({"params": p},
                                                           x))), params)
    assert any(np.isnan(np.asarray(g)).any()
               for g in jax.tree.leaves(jgrad))


@pytest.mark.parametrize("extra", [True, False])
def test_eblock(extra):
    rng = np.random.default_rng(3)
    jmod, tmod = jd.EBlock(8, extra_depth_wise=extra), td.EBlock(
        8, extra_depth_wise=extra)
    x = _x(rng, 8)
    params = randomized(init_shapes(jmod, x)["params"], rng)
    assert np.abs(params["beta"]).min() > 0 and np.abs(
        params["gamma"]).min() > 0
    load(tmod, params).eval()
    want = jmod.apply({"params": params}, x)
    with torch.no_grad():
        got = tmod(nchw(x))
    _close(got, want)


def test_dblock():
    rng = np.random.default_rng(4)
    want, got = pair(jd.DBlock(8, dilations=(1, 4, 9)),
                     td.DBlock(8, dilations=(1, 4, 9)), rng,
                     _x(rng, 8, 20, 18))
    _close(got, want)


TINY = dict(width=8, enc_blk_nums=(1, 1, 1), middle_blk_num_enc=1,
            middle_blk_num_dec=1, dec_blk_nums=(1, 1, 1))


@functools.lru_cache(maxsize=None)
def _jax_model(side_loss, bf16=False):
    rng = np.random.default_rng(10)
    x = rng.random((2, 30, 21, 3), dtype=np.float32)
    jnet = jd.DarkIR(**TINY, dtype=jnp.bfloat16 if bf16 else None)
    params = randomized(init_shapes(jnet, jnp.asarray(x),
                                    side_loss=side_loss)["params"], rng)
    out = compiled(lambda p, a: jnet.apply({"params": p}, a,
                                           side_loss=side_loss),
                   params, jnp.asarray(x))
    if side_loss:
        out = (out[0], out[1]["side"])
    return params, x, jax.tree.map(lambda a: np.asarray(a, np.float32), out)


def _port(params, keep_side, dtype=None):
    return load(get_model("darkir", **TINY, dtype=dtype).eval(), params,
                functools.partial(td.darkir_key_map, keep_side=keep_side))


@pytest.mark.parametrize("side_loss", [False, True])
def test_whole_model_matches_jax(side_loss):
    params, x, want = _jax_model(side_loss)
    assert ("side_out" in params) == side_loss
    model = _port(params, keep_side=side_loss)
    with torch.inference_mode():
        got = model(nchw(x), side_loss=side_loss)
    if side_loss:
        (want, want_side), (got, aux) = want, got
        assert set(aux) == {"side"} and aux["side"].shape == (2, 3, 4, 3)
        np.testing.assert_allclose(nhwc(aux["side"]), want_side, rtol=RTOL,
                                   atol=ATOL * np.abs(want_side).max())
    assert got.dtype == torch.float32 and got.shape == (2, 3, 30, 21)
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_key_map():
    key = "encoders.1.modules_list.0.freq.process1.0.weight"
    assert td.darkir_key_map(key) == jd.darkir_key_map(key) == \
        "encoders.1.0.freq.process1.0.weight"
    assert td.darkir_key_map("side_out.weight") is None
    assert td.darkir_key_map("side_out.weight", keep_side=True) == \
        "side_out.weight"
    assert "side_out.weight" in get_model("darkir", **TINY).state_dict()


def test_bf16_within_three_times_jax_bf16():
    params, x, want32 = _jax_model(False)
    _, _, want16 = _jax_model(False, bf16=True)
    with torch.inference_mode():
        got = _port(params, False, torch.bfloat16)(nchw(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err_port = np.abs(nhwc(got) - want32)
    err_jax = np.abs(want16 - want32)
    assert err_port.max() <= 3 * err_jax.max(), (err_port.max(),
                                                 err_jax.max())
    assert err_port.mean() <= 3 * err_jax.mean(), (err_port.mean(),
                                                   err_jax.mean())
