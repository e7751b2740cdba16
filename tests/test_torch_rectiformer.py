"""The port's RectiFormer (``models/rectiformer.py``) against the JAX
package's, on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``
``randomized``), the tree goes into the port through
``state_dict_from_jax``, and both run the same seeded numpy inputs in fp32
(JAX at "highest" matmul precision, torch with TF32 off); the port takes
NCHW, the JAX package NHWC.

Tolerance (``family_parity.hold``): relative L2 <= 1e-5 and max |error|
<= 1e-5 x max |JAX output|, for every module and the whole model. bf16:
the port's bf16 output against JAX's fp32 within 3x the JAX bf16 model's
error against it (max and mean; tests/test_tpu_kernels.py's rule).

* MSDRNet, MDPM, ElementwiseGatedAttention (with and without the dynamic
  temperature), GatedSpatialFFN, the Gaussian mask (the JAX module's
  numpy expression, NaN at the centre below an 8-high latent), DGSB at
  an 8x12 latent, DynamicTransformerBlock.
* The whole model at dim 8 (one block a level, one refinement block) at
  64x64 in fp32 and bf16 (72x96 through ``cli/infer.py``); at 32x32 both
  are NaN (the mask's width is 0), as the reference is.
* The whole model's input and parameter gradients against ``jax.grad``
  (no phase is taken, so no coefficient is ambiguous).
* ``cli/infer.py`` against the JAX ``make_restore_fn`` on a 70x90 image
  (reflect-padded to 72x96), and ``cli/train.py``'s ``build_model``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    bf16_within_three_times, grads_close, hold, init_shapes, load, nchw,
    nhwc, randomized,
)
from moe_parity import compiled

from image_restoration_tpu.cli.infer import make_restore_fn as jax_restore_fn
from image_restoration_tpu.models import rectiformer as jr
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import rectiformer as tr
from image_restoration_tpu_torch.ops.common import pad_to_multiple
from image_restoration_tpu_torch.utils.options import parse_options


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _x(rng, c, h=12, w=10, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


def _pair(jmod, tmod, rng, *inputs, to_torch=nchw):
    """(JAX output, port output) of the two modules on shared seeded
    weights; ``inputs`` in the JAX layout."""
    params = randomized(init_shapes(jmod, *inputs)["params"], rng)
    load(tmod, params).eval()
    want = jmod.apply({"params": params}, *inputs)
    with torch.no_grad():
        got = tmod(*(to_torch(a) for a in inputs))
    return want, got


def _vec(a):
    return torch.from_numpy(np.asarray(a))


def _to_torch(a):
    return nchw(a) if a.ndim == 4 else _vec(a)


def test_msdrnet():
    rng = np.random.default_rng(0)
    img = rng.random((2, 20, 18, 3), dtype=np.float32)
    (wp, wg), (gp, gg) = _pair(jr.MSDRNet(16, 3, (8, 16, 32, 64)),
                               tr.MSDRNet(3, 16, 3, (8, 16, 32, 64)), rng,
                               img)
    hold(gg.numpy(), wg)
    for g, w in zip(gp, wp):
        hold(g.numpy(), w)


def test_mdpm():
    rng = np.random.default_rng(1)
    x, ctx = _x(rng, 8), rng.standard_normal((2, 8)).astype(np.float32)
    (wx, wd), (gx, gd) = _pair(jr.MDPM(8, 8), tr.MDPM(8, 8), rng, x, ctx,
                               to_torch=_to_torch)
    hold(nhwc(gx), wx)
    hold(gd.numpy().reshape(-1), np.asarray(wd).reshape(-1))


@pytest.mark.parametrize("dynamic", [False, True])
def test_gated_attention(dynamic):
    rng = np.random.default_rng(2)
    x = _x(rng, 16)
    args = (x,)
    if dynamic:
        args += ((2 * rng.random((2, 1, 1, 1))).astype(np.float32),)
    want, got = _pair(jr.ElementwiseGatedAttention(16, 4),
                      tr.ElementwiseGatedAttention(16, 4), rng, *args,
                      to_torch=lambda a: nchw(a) if a.shape[1] > 1
                      else _vec(a))
    hold(nhwc(got), want)


def test_gated_spatial_ffn():
    rng = np.random.default_rng(3)
    want, got = _pair(jr.GatedSpatialFFN(8, 2.66),
                      tr.GatedSpatialFFN(8, 2.66), rng, _x(rng, 8))
    hold(nhwc(got), want)


@pytest.mark.parametrize("hw", [(8, 12), (9, 7), (4, 6)])
def test_gaussian_mask(hw):
    """The mask of the JAX module's expression (rectiformer.py:177-183),
    rounded to fp32 as JAX rounds it; below an 8-high map its width is 0:
    NaN at the centre, 0 elsewhere."""
    h, w = hw
    fh, fw = h, w // 2 + 1
    yy, xx = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
    dist2 = (xx - fw // 2) ** 2 + (yy - fh // 2) ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.exp(-dist2 / (2.0 * (h // 8) ** 2)).astype(np.float32)
    got = tr.gaussian_mask(h, w, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got is tr.gaussian_mask(h, w, "cpu")
    assert np.isnan(got.numpy()).any() == (h < 8)


def test_dgsb():
    rng = np.random.default_rng(4)
    x, g = _x(rng, 16, 8, 12), rng.standard_normal((2, 8)).astype(np.float32)
    want, got = _pair(jr.DGSB(16, 8), tr.DGSB(16, 8), rng, x, g,
                      to_torch=_to_torch)
    hold(nhwc(got), want)


def test_dynamic_block():
    rng = np.random.default_rng(5)
    x, p = _x(rng, 16), rng.standard_normal((2, 16)).astype(np.float32)
    want, got = _pair(jr.DynamicTransformerBlock(16, 2, 2.66),
                      tr.DynamicTransformerBlock(16, 2, 2.66), rng, x, p,
                      to_torch=_to_torch)
    hold(nhwc(got), want)


TINY = dict(dim=8, num_encoder_blocks=(1, 1, 1, 1),
            num_decoder_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
            context_dim=16)


@functools.lru_cache(maxsize=None)
def _jax_model(bf16=False):
    """(params, x, JAX output) of RectiFormer at ``TINY`` on a seeded
    (1, 64, 64, 3) image, compiled; the bf16 model draws the same
    weights."""
    rng = np.random.default_rng(10)
    jnet = jr.RectiFormer(**TINY, dtype=jnp.bfloat16 if bf16 else None)
    x = rng.random((1, 64, 64, 3), dtype=np.float32)
    params = _jax_model()[0] if bf16 else randomized(
        init_shapes(jr.RectiFormer(**TINY), jnp.zeros((1, 64, 64, 3)))
        ["params"], rng)
    want = compiled(lambda p, a: jnet.apply({"params": p}, a), params, x)
    return params, x, np.asarray(want, np.float32)


def _port(params, dtype=None):
    return load(get_model("rectiformer", **TINY, dtype=dtype), params).eval()


def test_whole_model_matches_jax():
    params, x, want = _jax_model()
    with torch.inference_mode():
        got = _port(params)(nchw(x))
    assert got.dtype == torch.float32 and got.shape == (1, 3, 64, 64)
    hold(nhwc(got), want)


def test_bf16_within_three_times_jax_bf16():
    params, x, want32 = _jax_model()
    _, _, want16 = _jax_model(bf16=True)
    with torch.inference_mode():
        got = _port(params, torch.bfloat16)(nchw(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    bf16_within_three_times(nhwc(got), want16, want32)


def test_nan_below_64_as_in_jax():
    """At 32x32 the latent is 4 high, the mask's width 4 // 8 = 0 and both
    packages' outputs are all NaN (the reference's torch division)."""
    params, x, _ = _jax_model()
    small = x[:, :32, :32]
    want = compiled(lambda p, a: jr.RectiFormer(**TINY).apply(
        {"params": p}, a), params, small)
    with torch.inference_mode():
        got = _port(params)(nchw(small))
    assert np.isnan(np.asarray(want)).all() and torch.isnan(got).all()


def test_gradients_match_jax():
    """d(sum(out * g))/d(input, every parameter) of the whole model at
    64x64 against ``jax.grad`` of the JAX model."""
    params, x, _ = _jax_model()
    jnet = jr.RectiFormer(**TINY)
    g = np.random.default_rng(11).standard_normal(x.shape).astype(np.float32)

    def loss(p, a):
        return jnp.sum(jnet.apply({"params": p}, a) * g)

    jgp, jgx = compiled(jax.grad(loss, argnums=(0, 1)), params, x)
    tnet = _port(params)
    xt = nchw(x).requires_grad_(True)
    (tnet(xt) * nchw(g)).sum().backward()
    hold(nhwc(xt.grad), jgx)
    grads_close(tnet, jgp)


def test_infer_matches_jax_restore_fn(tmp_path):
    """A 70x90 image through the port's ``make_restore_fn`` from the
    ``cli/infer.py`` options (reflect-padded to 72x96 at the default
    ``pad_multiple`` 8) and a JAX ``.npz``, against the JAX CLI's
    ``make_restore_fn`` with the same parameters (its jit at XLA's full
    optimisation); then ``main`` writes it. The restores clip to [0, 1],
    so the max |error| is held to 1e-5 x the largest |output| of the
    unclipped forward, as the whole model's is."""
    params, _, _ = _jax_model()
    img = np.random.default_rng(20).random((70, 90, 3), dtype=np.float32)
    sets = [a for k, v in TINY.items()
            for a in ("--set", f"model_kwargs.{k}={v}")]
    npz = str(tmp_path / "rectiformer.npz")
    save_params_npz(npz, params)
    argv = ["--model", "rectiformer", "--fp32", "--device", "cpu", "--ckpt",
            npz, *sets]
    cfg = parse_options(argv)
    assert cfg["pad_multiple"] == 8
    jcfg = {"model": "rectiformer", "pad_multiple": 8}
    want = jax_restore_fn(jcfg, jr.RectiFormer(**TINY), params)(img)
    model = load_params(cfg, build_model(cfg))
    got = infer.make_restore_fn(cfg, model)(img)
    assert got.shape == img.shape
    with torch.inference_mode():
        padded = pad_to_multiple(torch.from_numpy(img).permute(2, 0, 1)[None],
                                 8)[0]
        scale = model(padded).abs().max().item()
    hold(got, want, scale=scale)
    src = tmp_path / "in"
    src.mkdir()
    from PIL import Image

    Image.fromarray((img * 255).astype(np.uint8)).save(str(src / "a.png"))
    outs = infer.main(argv + ["--input", str(src), "--output_dir",
                              str(tmp_path / "out")])
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(70, 90, 3)]


def test_trains_through_cli(tmp_path):
    """Two steps of ``cli/train.py`` ``main`` at ``TINY`` on a seeded AIO
    tree (batch 2 of 64x64 patches, fp32, the CPU): finite logged losses
    and a checkpoint that loads into a fresh model."""
    import json

    from PIL import Image

    from image_restoration_tpu_torch.cli import train as train_cli

    rng = np.random.default_rng(30)

    def save(rel, arr):
        path = tmp_path / "data" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(arr.astype(np.uint8)).save(str(path))

    for i in range(2):
        clean = rng.random((72, 80, 3)) * 255
        noisy = np.clip(clean + rng.integers(-30, 30, clean.shape), 0, 255)
        save(f"denoising/{i}.png", clean)
        save(f"deraining/RainTrainL/gt/norain-{i}.png", clean)
        save(f"deraining/RainTrainL/rainy/norain-{i}.png", noisy)
        save(f"dehazing/RESIDE/clear/{i}.png", clean)
        save(f"dehazing/RESIDE/part1/{i}_0.8_0.1.png", clean * 0.7 + 50)
    sets = [a for k, v in TINY.items()
            for a in ("--set", f"model_kwargs.{k}={v}")]
    state = train_cli.main(
        ["--model", "rectiformer", "--device", "cpu", "--fp32",
         "--data_file_dir", str(tmp_path / "data"), "--patch_size", "64",
         "--batch_size", "2", "--warmup_epochs", "0", "--ckpt_dir",
         str(tmp_path / "exp"), "--name", "r", "--save_every", "2",
         "--log_every", "1", "--num_workers", "2", *sets],
        max_steps_override=2)
    assert state.step == 2
    logged = [json.loads(line) for line in open(tmp_path / "exp" / "r" /
                                                "metrics.jsonl")]
    assert [np.isfinite(e["train/total"]) for e in logged
            if "train/total" in e] == [True, True]
    saved = torch.load(str(tmp_path / "exp" / "r" / "ckpt" / "2.pth"))
    get_model("rectiformer", **TINY).load_state_dict(saved["params"])
