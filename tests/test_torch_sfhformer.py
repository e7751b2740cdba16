"""The port's SFHformer (``models/sfhformer.py``) against the JAX package's,
on the same weights and BatchNorm statistics.

Each JAX module gets seeded random parameters and running statistics
(``tests/family_parity.py``; the zero-initialised ``beta``/``gamma`` are
random too, so every branch reaches the output), the trees go into the
port through ``state_dict_from_jax``, and both run the same seeded numpy
inputs in fp32 (JAX at "highest" matmul precision, torch with TF32 off);
the port takes NCHW, the JAX package NHWC.

Tolerance: rtol=1e-4, atol=1e-5 for every module; the whole model and the
train step at atol=1e-5 x the largest |value| and rtol=1e-4. bf16: the
port's bf16 output against JAX's fp32 within 3x the JAX bf16 model's
error against it (max and mean).

* FFN, LocalMixer; FourierUnitGrouped at an even and an odd width (its
  (c, [re, im]) channel order is ``ops/fft.py``'s); Mixer; Block in eval
  mode and with ``train=True`` (batch statistics, the running ones
  updated as JAX's ``mutable=["batch_stats"]`` updates them).
* The whole model (a narrow configuration) at 32x24; bf16.
* One SGD step: the port's ``make_train_step`` with ``train=True`` (the
  training CLI's ``model_apply_kwargs``) against JAX's loss gradient with
  ``train=True`` and mutable statistics: the JAX CLI cannot train
  SFHformer (its step applies the parameters alone, and the BatchNorms
  read ``batch_stats``). Then a CPU step through ``cli/train.py`` ``main``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from family_parity import ATOL, RTOL, init_shapes, load, nchw, nhwc, pair, randomized
from moe_parity import compiled
from PIL import Image

from image_restoration_tpu.models import sfhformer as js
from image_restoration_tpu_torch.cli import train as train_cli
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import sfhformer as ts
from image_restoration_tpu_torch.train import trainer as TT
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _stats(tree, rng):
    """Seeded running statistics: means near 0, variances near 1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _stats(v, rng)
        elif k == "running_var":
            out[k] = (1.0 + 0.3 * np.abs(rng.standard_normal(v.shape))
                      ).astype(np.float32)
        else:
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _x(rng, c, h=12, w=10, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("name", ["ffn", "local"])
def test_ffn_and_local_mixer(name):
    rng = np.random.default_rng(0)
    jmod, tmod = {"ffn": (js.FFN(8), ts.FFN(8)),
                  "local": (js.LocalMixer(8), ts.LocalMixer(8))}[name]
    want, got = pair(jmod, tmod, rng, _x(rng, 8))
    _close(got, want)


@pytest.mark.parametrize("hw", [(12, 10), (9, 7)])
def test_fourier_unit_grouped(hw):
    """At an odd width the rfft2 keeps (W + 1) / 2 columns and the irfft2
    is told the width."""
    rng = np.random.default_rng(1)
    want, got = pair(js.FourierUnitGrouped(8), ts.FourierUnitGrouped(8),
                     rng, _x(rng, 8, *hw), batch_stats=_stats)
    _close(got, want)


def test_fourier_unit_channel_order():
    """The JAX module's stack([re, im], -1) layout is ``ops/fft.py``'s
    ``complex_to_channels``."""
    z = torch.randn(2, 3, 4, 5, dtype=torch.complex64)
    want = np.stack([z.real.numpy(), z.imag.numpy()], -1).transpose(
        0, 1, 4, 2, 3).reshape(2, 6, 4, 5)
    np.testing.assert_array_equal(ts.complex_to_channels(z).numpy(), want)


def test_mixer():
    rng = np.random.default_rng(2)
    want, got = pair(js.Mixer(8), ts.Mixer(8), rng, _x(rng, 8),
                     batch_stats=_stats)
    _close(got, want)


@pytest.mark.parametrize("train", [False, True])
def test_block(train):
    rng = np.random.default_rng(3)
    x = _x(rng, 8)
    jmod, tmod = js.Block(8), ts.Block(8)
    shapes = init_shapes(jmod, x)
    params = randomized(shapes["params"], rng)
    bs = _stats(shapes["batch_stats"], rng)
    load(tmod, params, batch_stats=bs)
    variables = {"params": params, "batch_stats": bs}
    if train:
        want, new = jmod.apply(variables, x, train=True,
                               mutable=["batch_stats"])
    else:
        want, new = jmod.apply(variables, x), {"batch_stats": bs}
    with torch.no_grad():
        got = tmod(nchw(x), train)
    _close(got, want)
    want_sd = state_dict_from_jax(params, tmod.state_dict(),
                                  batch_stats=jax.tree.map(np.array,
                                                           new["batch_stats"]))
    for k, v in tmod.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


TINY = dict(embed_dim=(8, 16, 32, 16, 8), depth=(1, 1, 1, 1, 1))


@functools.lru_cache(maxsize=None)
def _jax_model(bf16=False):
    rng = np.random.default_rng(10)
    x = rng.random((2, 32, 24, 3), dtype=np.float32)
    jnet = js.SFHformer(**TINY, dtype=jnp.bfloat16 if bf16 else None)
    shapes = init_shapes(jnet, jnp.asarray(x))
    params = randomized(shapes["params"], rng)
    bs = _stats(shapes["batch_stats"], rng)
    want = compiled(lambda v, a: jnet.apply(v, a),
                    {"params": params, "batch_stats": bs}, jnp.asarray(x))
    return params, bs, x, np.asarray(want, np.float32)


def _port(params, bs, dtype=None):
    return load(get_model("sfhformer", **TINY, dtype=dtype).eval(), params,
                batch_stats=bs)


def test_whole_model_matches_jax():
    params, bs, x, want = _jax_model()
    with torch.inference_mode():
        got = _port(params, bs)(nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32, 24)
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_bf16_within_three_times_jax_bf16():
    params, bs, x, want32 = _jax_model()
    _, _, _, want16 = _jax_model(bf16=True)
    with torch.inference_mode():
        got = _port(params, bs, torch.bfloat16)(nchw(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err_port = np.abs(nhwc(got) - want32)
    err_jax = np.abs(want16 - want32)
    assert err_port.max() <= 3 * err_jax.max(), (err_port.max(),
                                                 err_jax.max())
    assert err_port.mean() <= 3 * err_jax.mean(), (err_port.mean(),
                                                   err_jax.mean())


def test_train_step_matches_jax():
    """One SGD step at lr 0.1 (momentum 0.9: the trace after one step is
    the gradient) with the BatchNorms in train mode."""
    params, bs, _, _ = _jax_model()
    rng = np.random.default_rng(11)
    gt = rng.random((2, 32, 24, 3)).astype(np.float32)
    lq = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1).astype(
        np.float32)
    jnet = js.SFHformer(**TINY)

    def loss(p):
        out, new = jnet.apply({"params": p, "batch_stats": bs}, lq,
                              train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.abs(out - gt)), new["batch_stats"]

    (jl, jstats), jgrads = compiled(jax.value_and_grad(loss, has_aux=True),
                                    params)
    jparams = optax.apply_updates(params, jax.tree.map(lambda g: -0.1 * g,
                                                       jgrads))
    model = _port(params, bs)
    assert train_cli.model_apply_kwargs(model) == {"train": True}
    cfg = TT.TrainerConfig(learning_rate=0.1, optimizer="sgd",
                           apply_kwargs=train_cli.model_apply_kwargs(model))
    tx = TT.make_optimizer(cfg)
    state = TT.TrainState.create(model, tx)
    state, logs = TT.make_train_step(model, tx, cfg)(
        state, {"lq": nchw(lq), "gt": nchw(gt)})
    np.testing.assert_allclose(float(logs["l1"]), float(jl), RTOL, ATOL)
    like = model.state_dict()
    want_g = state_dict_from_jax(jax.tree.map(np.array, jgrads), like)
    scale = max(float(w.abs().max()) for w in want_g.values())
    for k, g in state.opt_state["trace"].items():
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), rtol=RTOL,
                                   atol=ATOL * scale, err_msg=k)
    want_sd = state_dict_from_jax(jax.tree.map(np.array, jparams), like,
                                  batch_stats=jax.tree.map(np.array, jstats))
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_trains_through_main(tmp_path):
    """A CPU step of a narrow SFHformer through ``cli/train.py`` ``main``:
    the running statistics move."""
    root = tmp_path / "aio"
    rng = np.random.default_rng(12)
    for i in range(2):
        clean = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
        noisy = np.clip(clean + rng.integers(-30, 30, clean.shape), 0, 255)
        for sub, img in (("gt", clean), ("rainy", noisy)):
            path = root / "deraining" / "RainTrainL" / sub / f"norain-{i}.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(path)
    argv = ["--device", "cpu", "--data_file_dir", str(root), "--de_type",
            "derain", "--patch_size", "32", "--batch_size", "2",
            "--warmup_epochs", "0", "--ckpt_dir", str(tmp_path), "--name",
            "t", "--save_every", "0", "--log_every", "1", "--num_workers",
            "1", "--fp32", "--model", "sfhformer", "--set",
            "model_kwargs.embed_dim=(8,16,32,16,8)", "--set",
            "model_kwargs.depth=(1,1,1,1,1)"]
    state = train_cli.main(argv, max_steps_override=1)
    assert state.step == 1
    logged = [json.loads(line) for line in open(tmp_path / "t" /
                                                "metrics.jsonl")]
    assert np.isfinite(logged[0]["train/total"])
    mean = state.model.layer1.blocks[0].norm1.running_mean
    assert mean.abs().max() > 0  # initialised at 0, moved by the step
