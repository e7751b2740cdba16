"""The port's IGMoCE-IR (``models/igmoce_ir.py``) and the illumination ops
(``ops/illumination.py``) against the JAX package's, on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``;
the zero-initialised ``gamma``/``beta`` scales are random too, so every
branch reaches the output), the tree goes into the port through
``state_dict_from_jax``, and both run the same seeded numpy inputs in fp32
(JAX at "highest" matmul precision, torch with TF32 off); the port takes
NCHW, the JAX package NHWC.

Tolerance: rtol=1e-4, atol=1e-5 for every module; the whole model at
atol=1e-5 x the largest |output| (random weights give outputs near 10) and
rtol=1e-4, with the routers' top-1/top-2 softmax gap above 1e-5 (fp32
rounding is ~1e-7), so no pick can flip between the packages.

* ``ops/illumination.py``: IlluminationEstimator with IGMoCE-IR's 4 groups
  and LumiSenseMoE's ``depth_groups``; AdaptiveIlluminationModulator.
* Modules: HolisticLayerNorm (with and without bias), the LN dispatcher
  over its four types, FreMLPExp (an even and an odd width; its
  gradients against the reference's ``torch.abs``/``torch.angle``
  formulation and JAX's, finite where a coefficient is 0), SpAM (with
  and without the extra depthwise conv), IG_MSA, IGEncoderBlock,
  IGAdapterLayer (image gate only, dense at batch 1), IGDecoderBlock.
* The whole model at dim 16, one block a level, 16x24 (no internal pad),
  and ``igmoce_key_map``; a JAX ``.npz`` through ``load_params``;
  ``cli/infer.py --model igmoce_ir`` on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    ATOL,
    GAP_MIN,
    RTOL,
    init_shapes,
    load,
    nchw,
    nhwc,
    pair,
    randomized,
    routing_gaps,
)
from PIL import Image

from image_restoration_tpu.models import igmoce_ir as jg
from image_restoration_tpu.ops import illumination as jil
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import igmoce_ir as tg
from image_restoration_tpu_torch.ops import illumination as til


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


@pytest.mark.parametrize("groups", [None, 16])
def test_illumination_estimator(groups):
    rng = np.random.default_rng(0)
    img = rng.random((2, 12, 10, 3), dtype=np.float32)
    (wf, wm), (gf, gm) = pair(
        jil.IlluminationEstimator(16, depth_groups=groups),
        til.IlluminationEstimator(16, depth_groups=groups), rng, img)
    _close(gf, wf)
    _close(gm, wm)


def test_illumination_modulator():
    rng = np.random.default_rng(1)
    want, got = pair(jil.AdaptiveIlluminationModulator(8),
                     til.AdaptiveIlluminationModulator(8), rng, _x(rng, 8))
    _close(got, want)


@pytest.mark.parametrize("with_bias", [True, False])
def test_holistic_layer_norm(with_bias):
    rng = np.random.default_rng(2)
    x = (3 * _x(rng, 8) + 1).astype(np.float32)
    want, got = pair(jg.HolisticLayerNorm(with_bias),
                     tg.HolisticLayerNorm(8, with_bias), rng, x)
    _close(got, want)


@pytest.mark.parametrize("ln_type", ["BiasFree", "WithBias",
                                     "HolisticWithBias", "HolisticBiasFree"])
def test_ln_dispatcher(ln_type):
    rng = np.random.default_rng(3)
    want, got = pair(jg.LN(ln_type), tg.LN(8, ln_type), rng, _x(rng, 8))
    _close(got, want)


@pytest.mark.parametrize("hw", [(12, 10), (9, 11)])
def test_fre_mlp(hw):
    rng = np.random.default_rng(4)
    want, got = pair(jg.FreMLPExp(8, 2, True), tg.FreMLPExp(8, 2, True), rng,
                     _x(rng, 8, *hw))
    _close(got, want)


def _reference_fre_mlp(mod, x):
    """The reference's FreMLP (``torch.abs`` and ``torch.angle`` of the
    rfft2 coefficients) with the port module's weights."""
    z = torch.fft.rfft2(x, norm="backward")
    m, pha = mod.process1(torch.abs(z)), torch.angle(z)
    return torch.fft.irfft2(torch.complex(m * torch.cos(pha),
                                          m * torch.sin(pha)),
                            s=x.shape[-2:], norm="backward")


@pytest.mark.parametrize("zeros", [False, True],
                         ids=["random", "zero_coefficients"])
def test_fre_mlp_gradient(zeros):
    """The input and weight gradients equal the reference's FreMLP's and
    JAX's; where an rfft2 coefficient is exactly 0 (constant channels of a
    4x4 map) JAX's are NaN and the port's stay the reference's."""
    rng = np.random.default_rng(6)
    x = _x(rng, 8, 4, 4)
    if zeros:
        x[..., :4] = 0.5
    cot = _x(rng, 8, 4, 4)
    jmod = jg.FreMLPExp(8, 2, True)
    params = randomized(init_shapes(jmod, x)["params"], rng)
    tmod = load(tg.FreMLPExp(8, 2, True), params)
    grads = []
    for fn in (tmod, functools.partial(_reference_fre_mlp, tmod)):
        xt = nchw(x).requires_grad_()
        tmod.zero_grad()
        (fn(xt) * nchw(cot)).sum().backward()
        grads.append([xt.grad] + [p.grad.clone()
                                  for p in tmod.parameters()])
    for got, want in zip(*grads):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), RTOL,
                                   ATOL * float(want.abs().max()))
    jgrad = jax.grad(lambda a: jnp.sum(jmod.apply({"params": params}, a)
                                       * cot))(x)
    if zeros:
        assert np.isnan(np.asarray(jgrad)).any()
    else:
        _close(grads[0][0], jgrad, atol=ATOL * float(np.abs(jgrad).max()))


@pytest.mark.parametrize("extra", [False, True])
def test_spam(extra):
    rng = np.random.default_rng(5)
    want, got = pair(jg.SpAM(8, 2, (1, 4, 9), extra),
                     tg.SpAM(8, 2, (1, 4, 9), extra), rng, _x(rng, 8, 20, 18))
    _close(got, want)


def test_ig_msa():
    rng = np.random.default_rng(6)
    want, got = pair(jg.IG_MSA(8, 2, True), tg.IG_MSA(8, 2, True), rng,
                     _x(rng, 8), _x(rng, 8))
    _close(got, want)


def test_ig_encoder_block():
    rng = np.random.default_rng(7)
    want, got = pair(jg.IGEncoderBlock(16, 1, dilations=(1, 4)),
                     tg.IGEncoderBlock(16, 1, dilations=(1, 4)), rng,
                     _x(rng, 16), _x(rng, 8))
    _close(got, want)


def test_ig_adapter_layer():
    rng = np.random.default_rng(8)
    x, s = _x(rng, 16, b=1), _x(rng, 16, b=1)
    tmod = tg.IGAdapterLayer(16, 2, 4, 1)
    (want, _), got = pair(jg.IGAdapterLayer(16, 2, 4, 1), tmod, rng, x, s)
    assert tmod.routing.freq_gate is None
    gaps = routing_gaps(tmod)
    with torch.no_grad():
        tmod(nchw(x), nchw(s))
    assert min(gaps) > GAP_MIN
    _close(got, want)


def test_ig_decoder_block():
    rng = np.random.default_rng(9)
    tmod = tg.IGDecoderBlock(16, 2, rank=2, num_experts=4, top_k=2)
    (want, _), got = pair(jg.IGDecoderBlock(16, 2, rank=2, num_experts=4,
                                            top_k=2), tmod, rng, _x(rng, 16))
    _close(got, want)


TINY = dict(dim=16, num_blocks=(1, 1, 1, 1), dilations=(1, 4))


@functools.lru_cache(maxsize=None)
def _jax_model():
    x = np.random.default_rng(20).random((1, 16, 24, 3), dtype=np.float32)
    jnet = jg.IGMoCEIR(**TINY)
    params = randomized(init_shapes(jnet, jnp.asarray(x))["params"],
                        np.random.default_rng(21))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, a: jnet.apply({"params": p}, a))(
            params, jnp.asarray(x)))
    return params, x, want


def test_whole_model_matches_jax():
    params, x, want = _jax_model()
    tnet = load(get_model("igmoce_ir", **TINY).eval(), params,
                tg.igmoce_key_map)
    gaps = routing_gaps(tnet)
    with torch.inference_mode():
        got = tnet(nchw(x))
    assert got.dtype == torch.float32
    assert len(gaps) == 3 and min(gaps) > GAP_MIN
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_key_map_and_npz(tmp_path):
    assert tg.igmoce_key_map("dec.0.2.layers.0.adapter.routing.complexity") \
        is None
    assert tg.igmoce_key_map("dec.0.2.0.adapter.routing.freq_gate.weight") \
        is None
    assert (tg.igmoce_key_map("enc.1.0.layers.0.mixer.qkv.weight")
            == jg.igmoce_key_map("enc.1.0.layers.0.mixer.qkv.weight")
            == "enc.1.0.0.mixer.qkv.weight")
    assert tg.igmoce_key_map("illu_patch_embed.main.0.weight") == \
        "illu_patch_embed.weight"
    params, x, want = _jax_model()
    path = str(tmp_path / "igmoce.npz")
    save_params_npz(path, params)
    model = load_params({"model": "igmoce_ir", "ckpt": path},
                        get_model("igmoce_ir", **TINY)).eval()
    np.testing.assert_array_equal(
        model.state_dict()["enc.0.0.0.gamma"].numpy().reshape(-1),
        params["enc_0_0_0"]["gamma"].reshape(-1))
    with torch.inference_mode():
        got = model(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_infer_cli_serves_igmoce_ir(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    arr = (np.random.default_rng(30).random((37, 45, 3)) * 255).astype(
        np.uint8)
    Image.fromarray(arr).save(str(src / "im.png"))
    sets = ["--set", "model_kwargs.dim=16",
            "--set", "model_kwargs.num_blocks=(1,1,1,1)"]
    outs = infer.main(["--model", "igmoce_ir", "--device", "cpu",
                       "--input", str(src), "--output_dir",
                       str(tmp_path / "out")] + sets)
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(37, 45, 3)]
