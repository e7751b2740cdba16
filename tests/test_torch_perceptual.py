"""The port's ``eval/perceptual.py`` against the JAX package's, on the same
random weights, in fp32 (JAX at "highest", torch with TF32 off).

* VGG16Features at TransWeather's taps (relu1_2/2_2/3_3) and at a conv
  output, three pools and relu5_3, ``perceptual_loss`` (MSE and L1),
  LPIPS, on seeded weights through ``state_dict_from_jax``: rtol
  1e-4, atol 1e-5 (LPIPS's distances at atol 1e-6: they are ~1e-3).
* Checkpoints: a torchvision-layout vgg16 state_dict (features and
  classifier) built here loads through ``vgg16_key_map`` into the port
  (``cli/train.py`` ``build_recipe_kwargs``) and through the JAX
  package's importer, and the two trunks agree; an LPIPS-layout
  checkpoint (``net.features.N``, ``lin{i}.model.1.weight``) through
  ``lpips_key_map`` into ``cli/test.py``'s ``make_lpips_fn`` and into
  JAX's LPIPS, the same distances; ``cli/test.py --lpips_ckpt`` prints and
  writes the LPIPS column.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import ATOL, RTOL, load, nchw, nhwc, randomized
from moe_parity import compiled, fp32_matmuls, traced_shapes  # noqa: F401
from PIL import Image

from image_restoration_tpu.eval import perceptual as JP
from image_restoration_tpu.utils.torch_import import import_state_dict
from image_restoration_tpu_torch.cli import test as test_cli
from image_restoration_tpu_torch.cli import train as train_cli
from image_restoration_tpu_torch.eval import perceptual as TP

def _images(seed, n=2, h=32, w=40):
    rng = np.random.default_rng(seed)
    return [rng.random((n, h, w, 3), dtype=np.float32) for _ in range(2)]


@pytest.mark.parametrize("taps", [(3, 8, 15), (1, 4, 9, 16, 29)])
def test_vgg16_features(taps):
    rng = np.random.default_rng(0)
    x, _ = _images(1)
    jv = JP.VGG16Features(taps=taps)
    params = randomized(traced_shapes(jv, jnp.asarray(x))["params"], rng)
    tv = load(TP.VGG16Features(taps), params)
    want = compiled(lambda p, a: jv.apply({"params": p}, a), params,
                    jnp.asarray(x))
    with torch.no_grad():
        got = tv(nchw(x))
    assert len(got) == len(want) == len(taps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), RTOL,
                                   ATOL * float(np.abs(w).max()))


@pytest.mark.parametrize("criterion", ["mse", "l1"])
def test_perceptual_loss(criterion):
    rng = np.random.default_rng(2)
    pred, gt = _images(3)
    jv = JP.VGG16Features(taps=(3, 8, 15))
    params = randomized(traced_shapes(jv, jnp.asarray(pred))["params"], rng)
    want = compiled(lambda p, a, b: JP.perceptual_loss(jv, p, a, b,
                                                       criterion),
                    params, jnp.asarray(pred), jnp.asarray(gt))
    with torch.no_grad():
        got = TP.perceptual_loss(load(TP.VGG16Features(), params),
                                 nchw(pred), nchw(gt), criterion)
    np.testing.assert_allclose(float(got), float(want), RTOL, ATOL)


def _jax_lpips(params, x, y):
    lp = JP.LPIPS()
    return np.asarray(compiled(lambda p, a, b: lp.apply({"params": p}, a, b),
                               params, jnp.asarray(x), jnp.asarray(y)))


def _lpips_params(rng, x):
    params = randomized(traced_shapes(JP.LPIPS(), jnp.asarray(x),
                                      jnp.asarray(x))["params"], rng)
    for i in range(5):  # LPIPS's heads are non-negative
        params[f"lin{i}"]["conv"]["kernel"] = np.abs(
            params[f"lin{i}"]["conv"]["kernel"])
    return params


def test_lpips():
    rng = np.random.default_rng(4)
    x, y = _images(5)
    params = _lpips_params(rng, x)
    want = _jax_lpips(params, x, y)
    with torch.no_grad():
        got = load(TP.LPIPS(), params)(nchw(x), nchw(y))
    assert got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want, RTOL, 1e-6)


def _zeros(shapes):
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _torchvision_vgg16(seed):
    """A torchvision-layout vgg16 state_dict: the 13 convs of ``features``
    and the classifier, seeded."""
    g = torch.Generator().manual_seed(seed)
    sd, cin, idx = {}, 3, 0
    for v in TP.VGG16_CFG:
        if v == "M":
            idx += 1
            continue
        fan = cin * 9
        sd[f"features.{idx}.weight"] = torch.randn(v, cin, 3, 3,
                                                   generator=g) / fan ** 0.5
        sd[f"features.{idx}.bias"] = 0.01 * torch.randn(v, generator=g)
        cin, idx = v, idx + 2
    for i, (o, n) in enumerate(((64, 512 * 7 * 7), (64, 64), (10, 64))):
        sd[f"classifier.{3 * i}.weight"] = torch.zeros(o, n)
        sd[f"classifier.{3 * i}.bias"] = torch.zeros(o)
    return sd


def test_vgg16_key_map_loads_a_torchvision_checkpoint(tmp_path):
    sd = _torchvision_vgg16(6)
    torch.save(sd, tmp_path / "vgg16.pth")
    assert TP.vgg16_key_map("classifier.0.weight") is None
    assert TP.vgg16_key_map("features.28.bias") == "features.28.bias"
    vgg = train_cli.build_recipe_kwargs(
        {"recipe": "transweather", "vgg_ckpt": str(tmp_path / "vgg16.pth"),
         "device": "cpu"})["vgg"]
    for k, v in vgg.state_dict().items():
        assert torch.equal(v, sd[k]), k
    jv = JP.VGG16Features(taps=(3, 8, 15))
    x, _ = _images(7)
    shapes = traced_shapes(jv, jnp.asarray(x))["params"]
    jsd = {JP.vgg16_key_map(k): v.numpy() for k, v in sd.items()
           if JP.vgg16_key_map(k) is not None}
    params = import_state_dict(_zeros(shapes), jsd, strict=False)
    want = compiled(lambda p, a: jv.apply({"params": p}, a), params,
                    jnp.asarray(x))
    with torch.no_grad():
        got = vgg(nchw(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), RTOL,
                                   ATOL * float(np.abs(w).max()))


def _lpips_checkpoint(path):
    """An LPIPS-layout checkpoint: the VGG16 trunk under ``net.`` (to
    relu5_3) and the five heads as ``lin{i}.model.1.weight``."""
    sd = {f"net.{k}": v for k, v in _torchvision_vgg16(8).items()
          if k.startswith("features.") and int(k.split(".")[1]) < 29}
    g = torch.Generator().manual_seed(9)
    for i, c in enumerate((64, 128, 256, 512, 512)):
        sd[f"lin{i}.model.1.weight"] = torch.rand(1, c, 1, 1, generator=g)
    torch.save(sd, path)
    return sd


def test_lpips_checkpoint_in_both_packages(tmp_path):
    sd = _lpips_checkpoint(tmp_path / "lpips.pth")
    fn = test_cli.make_lpips_fn(str(tmp_path / "lpips.pth"), "cpu")
    x, y = _images(10)
    got = fn(nchw(x), nchw(y))
    shapes = traced_shapes(JP.LPIPS(), jnp.asarray(x), jnp.asarray(y))
    params = import_state_dict(
        _zeros(shapes["params"]),
        {k: v.numpy() for k, v in sd.items()}, key_map=JP.lpips_key_map)
    np.testing.assert_allclose(got.numpy(), _jax_lpips(params, x, y), RTOL,
                               1e-6)


def test_cli_test_scores_lpips(tmp_path):
    _lpips_checkpoint(tmp_path / "lpips.pth")
    rng = np.random.default_rng(11)
    for i in range(2):
        gt = (rng.random((40, 48, 3)) * 255).astype(np.uint8)
        lq = np.clip(gt + rng.integers(-20, 20, gt.shape), 0, 255)
        for sub, img in (("target", gt), ("input", lq)):
            path = tmp_path / "deraining" / "Rain100L" / sub / f"{i}.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(path)
    out = tmp_path / "out"
    results = test_cli.main([
        "--device", "cpu", "--model", "darkir", "--fp32",
        "--set", "model_kwargs.width=8", "--benchmarks", "derain",
        "--data_file_dir", str(tmp_path), "--lpips_ckpt",
        str(tmp_path / "lpips.pth"), "--output_dir", str(out)])
    lp = results["derain"]["lpips"]
    assert np.isfinite(lp) and lp > 0
    assert json.load(open(out / "results.json")) == results
