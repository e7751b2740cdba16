"""The port's ``darkir`` and ``transweather`` training recipes
(``train/recipes.py``), their models' train steps and their ``cli/train.py``
runs, against the JAX package's, in fp32 (JAX at "highest", torch with
TF32 off).

* Each recipe's terms and the gradients of its total with respect to the
  model outputs, on the same seeded outputs: DarkIR's pixel L1 and its
  side head's EnhanceLoss (the side nearest-upsampled x8), and without a
  side head; TransWeather's smooth L1 and its VGG16 perceptual term
  (seeded VGG weights through the bridge), and without VGG. Values at
  rtol 1e-4, atol 1e-5; gradients at atol 1e-5 x the largest.
* One ``make_train_step`` step of a narrow DarkIR (``side_loss=True``,
  ``RECIPE_APPLY_KWARGS``) and of a narrow TransWeather (with the
  perceptual term) against the JAX step on the same batch: the logged
  terms, every gradient (SGD with momentum, whose trace after one step is
  the gradient) at atol 1e-5 x the model's largest gradient, and the
  updated parameters at rtol 1e-4, atol 1e-5.
* One CPU step of each through ``cli/train.py`` ``main``: ``--recipe
  darkir`` logs the enhance term; ``--recipe transweather --vgg_ckpt``
  reads a torchvision-layout vgg16 ``.pth`` (classifier included) and
  logs the perceptual term.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (ATOL, RTOL, init_shapes, load, nchw, nhwc, randomized,
                           train_step_pair)
from moe_parity import compiled, fp32_matmuls, traced_shapes  # noqa: F401
from PIL import Image

from image_restoration_tpu.eval import perceptual as JP
from image_restoration_tpu.models import darkir as jd
from image_restoration_tpu.models import transweather as jt
from image_restoration_tpu.train import recipes as JR
from image_restoration_tpu_torch.cli import train as train_cli
from image_restoration_tpu_torch.eval import perceptual as TP
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.train import recipes as TR

VGG_TAPS = (3, 8, 15)


def _grads_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()))


def _vgg(rng, size=64):
    """Seeded VGG16 (relu3_3) parameters and the port module holding
    them."""
    jv = JP.VGG16Features(taps=VGG_TAPS)
    x = np.zeros((1, size, size, 3), np.float32)
    params = randomized(traced_shapes(jv, jnp.asarray(x))["params"], rng)
    return params, load(TP.VGG16Features(VGG_TAPS), params)


@pytest.mark.parametrize("side", [True, False])
def test_darkir_recipe_matches_jax(side):
    rng = np.random.default_rng(0)
    out = rng.random((2, 32, 24, 3)).astype(np.float32)
    sd = rng.random((2, 4, 3, 3)).astype(np.float32)
    gt = rng.random((2, 32, 24, 3)).astype(np.float32)

    def jloss(o, s):
        return JR.darkir_recipe()(o, {"side": s} if side else {},
                                  {"gt": jnp.asarray(gt)})

    (jtotal, jlogs), jgrads = jax.value_and_grad(jloss, (0, 1),
                                                 has_aux=True)(out, sd)
    o, s = nchw(out).requires_grad_(), nchw(sd).requires_grad_()
    total, logs = TR.darkir_recipe()(o, {"side": s} if side else {},
                                     {"gt": nchw(gt)})
    assert set(logs) == set(jlogs) == ({"l1", "enhance"} if side else {"l1"})
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   RTOL,
                                   ATOL)
    total.backward()
    _grads_close(nhwc(o.grad), jgrads[0])
    if side:
        _grads_close(nhwc(s.grad), jgrads[1])


@pytest.mark.parametrize("perceptual", [True, False])
def test_transweather_recipe_matches_jax(perceptual):
    rng = np.random.default_rng(1)
    out = (2 * rng.random((2, 32, 32, 3)) - 1).astype(np.float32)
    gt = rng.random((2, 32, 32, 3)).astype(np.float32)
    params, vgg = _vgg(rng) if perceptual else (None, None)

    def jloss(o):
        return JR.transweather_recipe(vgg_params=params)(
            o, {}, {"gt": jnp.asarray(gt)})

    (jtotal, jlogs), jgrad = compiled(
        jax.value_and_grad(jloss, has_aux=True), out)
    o = nchw(out).requires_grad_()
    total, logs = TR.transweather_recipe(vgg=vgg)(o, {}, {"gt": nchw(gt)})
    assert set(logs) == set(jlogs) == ({"smooth_l1", "perceptual"}
                                       if perceptual else {"smooth_l1"})
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   RTOL,
                                   ATOL)
    total.backward()
    _grads_close(nhwc(o.grad), jgrad)
    if perceptual:
        assert all(not p.requires_grad for p in vgg.parameters())


DARKIR = dict(width=8, enc_blk_nums=(1, 1, 1), middle_blk_num_enc=1,
              middle_blk_num_dec=1, dec_blk_nums=(1, 1, 1))
TRANSWEATHER = dict(embed_dims=(16, 32, 40, 64), num_heads=(1, 2, 2, 2),
                    depths=(1, 1, 1, 1), dec_depth=1, dec_heads=2)


def _step_pair(name, jnet, recipe, apply_kwargs, recipe_kwargs,
               port_recipe_kwargs, key_map=None, size=32):
    rng = np.random.default_rng(5)
    gt = rng.random((2, size, size, 3)).astype(np.float32)
    lq = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1).astype(
        np.float32)
    params = randomized(init_shapes(jnet, jnp.asarray(lq),
                                    **apply_kwargs)["params"], rng)
    cfg = {"darkir": DARKIR, "transweather": TRANSWEATHER}[name]
    tnet = load(get_model(name, **cfg), params, key_map)
    return train_step_pair(jnet, tnet, params, {"lq": lq, "gt": gt}, recipe,
                           apply_kwargs, recipe_kwargs, port_recipe_kwargs,
                           key_map)


def test_darkir_train_step_matches_jax():
    logs = _step_pair("darkir", jd.DarkIR(**DARKIR), "darkir",
                      train_cli.RECIPE_APPLY_KWARGS["darkir"], {}, {},
                      lambda k: jd.darkir_key_map(k, keep_side=True))
    assert set(logs) == {"l1", "enhance", "total"}


def test_transweather_train_step_matches_jax():
    params, vgg = _vgg(np.random.default_rng(6))
    logs = _step_pair("transweather", jt.Transweather(**TRANSWEATHER),
                      "transweather", {}, {"vgg_params": params},
                      {"vgg": vgg}, size=64)
    assert set(logs) == {"smooth_l1", "perceptual", "total"}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A seeded rain pair tree (``deraining/RainTrainL``) for ``main``."""
    root = tmp_path_factory.mktemp("aio")
    rng = np.random.default_rng(7)
    for i in range(2):
        clean = (rng.random((72, 72, 3)) * 255).astype(np.uint8)
        noisy = np.clip(clean + rng.integers(-30, 30, clean.shape), 0, 255)
        for sub, img in (("gt", clean), ("rainy", noisy)):
            path = root / "deraining" / "RainTrainL" / sub / f"norain-{i}.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(path)
    return str(root)


def _torchvision_vgg16(path):
    """A torchvision-layout vgg16 state_dict (all 13 convs of
    ``features`` and the classifier), seeded, saved to ``path``."""
    g = torch.Generator().manual_seed(8)
    sd, cin, idx = {}, 3, 0
    for v in TP.VGG16_CFG:
        if v == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = 0.05 * torch.randn(v, cin, 3, 3,
                                                          generator=g)
        sd[f"features.{idx}.bias"] = 0.01 * torch.randn(v, generator=g)
        cin, idx = v, idx + 2
    for i, (o, n) in enumerate(((4096, 512 * 7 * 7), (4096, 4096),
                                (1000, 4096))):
        sd[f"classifier.{3 * i}.weight"] = torch.zeros(o, n)
        sd[f"classifier.{3 * i}.bias"] = torch.zeros(o)
    torch.save(sd, path)
    return sd


def _main(data_root, tmp_path, patch, *extra):
    argv = ["--device", "cpu", "--data_file_dir", data_root, "--de_type",
            "derain", "--patch_size", str(patch), "--batch_size", "2",
            "--warmup_epochs", "0", "--ckpt_dir", str(tmp_path), "--name",
            "t", "--save_every", "0", "--log_every", "1", "--num_workers",
            "1", "--fp32", *extra]
    state = train_cli.main(argv, max_steps_override=1)
    assert state.step == 1
    logged = [json.loads(line) for line in open(tmp_path / "t" /
                                                "metrics.jsonl")]
    return {k: v for e in logged for k, v in e.items()}


def test_darkir_trains_through_main(data_root, tmp_path):
    logs = _main(data_root, tmp_path, 32, "--model", "darkir", "--recipe",
                 "darkir", "--set", "model_kwargs.width=8")
    assert all(np.isfinite(logs[f"train/{k}"])
               for k in ("l1", "enhance", "total"))


def test_transweather_trains_through_main(data_root, tmp_path):
    sd = _torchvision_vgg16(tmp_path / "vgg16.pth")
    vgg = train_cli.build_recipe_kwargs(
        {"recipe": "transweather", "vgg_ckpt": str(tmp_path / "vgg16.pth"),
         "device": "cpu"})["vgg"]
    assert len(vgg.features) == 16
    for k, v in vgg.state_dict().items():
        assert torch.equal(v, sd[k]), k
    logs = _main(data_root, tmp_path, 64, "--model", "transweather", "--recipe",
                 "transweather", "--vgg_ckpt", str(tmp_path / "vgg16.pth"),
                 "--set", "model_kwargs.embed_dims=(16,32,40,64)",
                 "--set", "model_kwargs.num_heads=(1,2,2,2)")
    assert all(np.isfinite(logs[f"train/{k}"])
               for k in ("smooth_l1", "perceptual", "total"))
