"""The port's NeRD-Rain (MultiscaleNet) against the JAX package's, on the
same weights (seeded trees of ``tests/family_parity.py`` through
``state_dict_from_jax`` with ``nerd_rain_key_map``), fp32, JAX at "highest"
matmul precision and torch with TF32 off.

* ``_interp`` (nearest, index int(i / scale)) and ``unfold3x3``: exact.
* Modules (Fusion, MLP, INR): rtol=1e-4, atol=1e-5.
* The whole model at dim 8, one block a level, 64x64, plain and
  ``fused_block``, all 7 outputs against the JAX model's: atol=2e-4.
* Options: ``pad_multiple`` is 16 for nerd_rain unless given, 8 for the
  other models.
* Entry points: a JAX ``.npz`` through ``load_params`` (and a torch
  state_dict with the reference's unused ``reduce_chan_level1_max3``,
  dropped by the key map), and ``cli/test.py`` on a derain tree against
  the JAX ``cli/test.py`` given ``--pad_multiple 16`` (PSNR 1e-4 dB, SSIM
  1e-5, the tolerances of tests/test_torch_benchmarks.py).
"""

import functools
import json
import os

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
from PIL import Image

from image_restoration_tpu.cli import test as jax_test
from image_restoration_tpu.models import nerd_rain as jn
from image_restoration_tpu.ops import inr as jinr
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli import test as port_test
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import nerd_rain as tn
from image_restoration_tpu_torch.ops import inr as tinr
from image_restoration_tpu_torch.utils.options import parse_options

TINY = dict(dim=8, num_blocks=(1, 1, 1), heads=(1, 2, 4))
TINY_ARGS = ["--fp32", "--set", "model_kwargs.dim=8",
             "--set", "model_kwargs.num_blocks=(1,1,1)"]


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("scale", [0.25, 0.5, 2])
@pytest.mark.parametrize("hw", [(16, 24), (12, 20)])
def test_interp_is_exact(scale, hw):
    x = np.random.default_rng(0).random((2,) + hw + (3,), dtype=np.float32)
    want = np.asarray(jn._interp(jnp.asarray(x), scale))
    got = nhwc(tn._interp(nchw(x), scale))
    np.testing.assert_array_equal(got, want)


def test_unfold3x3_is_exact():
    x = np.random.default_rng(1).random((2, 7, 5, 4), dtype=np.float32)
    want = np.asarray(jinr.unfold3x3(jnp.asarray(x)))
    np.testing.assert_array_equal(nhwc(tinr.unfold3x3(nchw(x))), want)
    torch_unfold = torch.nn.functional.unfold(nchw(x), 3, padding=1)
    np.testing.assert_array_equal(
        tinr.unfold3x3(nchw(x)).reshape(2, 36, 35).numpy(),
        torch_unfold.numpy())


def test_fusion():
    rng = np.random.default_rng(2)
    x, y = (rng.standard_normal((2, 8, 6, 16)).astype(np.float32)
            for _ in range(2))
    want, got = pair(jn.Fusion(16), tn.Fusion(16), rng, x, y)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_mlp():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 40)).astype(np.float32)
    want, got = pair(jinr.MLP(3, (32, 24)), tinr.MLP(40, 3, (32, 24)), rng, x,
                     to_torch=torch.from_numpy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_inr():
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((2, 8, 6, 8)).astype(np.float32)
    want, got = pair(jinr.INR(8), tinr.INR(8), rng, feat)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@functools.lru_cache(maxsize=None)
def _jax_model():
    """Params, input and the 7 outputs of the plain JAX model at 64x64. On
    the CPU the JAX ``fused_block`` runs the same composition, so this is
    the reference of both of the port's block modes."""
    rng = np.random.default_rng(5)
    x = rng.random((1, 64, 64, 3), dtype=np.float32)
    jnet = jn.MultiscaleNet(**TINY)
    params = randomized(init_shapes(jnet, jnp.asarray(x))["params"], rng)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, a: jnet.apply({"params": p}, a))(
            params, jnp.asarray(x))
    return params, x, [np.asarray(w) for w in want]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_whole_model_matches_jax(fused):
    params, x, want = _jax_model()
    tnet = load(get_model("nerd_rain", **TINY, fused_block=fused).eval(),
                params, tn.nerd_rain_key_map)
    with torch.inference_mode():
        got = tnet(nchw(x))
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        assert g.shape[-2:] == w.shape[1:3], i
        np.testing.assert_allclose(nhwc(g), w, rtol=0, atol=2e-4,
                                   err_msg=f"output {i}")


def test_pad_multiple_defaults():
    assert parse_options(["--model", "nerd_rain"])["pad_multiple"] == 16
    assert parse_options(["--model", "nerd_rain", "--pad_multiple",
                          "8"])["pad_multiple"] == 8
    for name in ("restormer", "cg_ir", "measnet"):
        assert parse_options(["--model", name])["pad_multiple"] == 8


def test_checkpoints_load(tmp_path):
    params, _, _ = _jax_model()
    path = str(tmp_path / "nerd.npz")
    save_params_npz(path, params)
    cfg = {"model": "nerd_rain", "ckpt": path}
    model = load_params(cfg, get_model("nerd_rain", **TINY))
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["INR2.imnet.layers.6.weight"].numpy(),
        params["INR2"]["imnet"]["layers_6"]["kernel"].T)
    assert not any(k.startswith("reduce_chan_level1_max3") for k in sd)

    torch_sd = dict(sd)
    torch_sd["reduce_chan_level1_max3.weight"] = torch.zeros(8, 16, 1, 1)
    cfg["ckpt"] = str(tmp_path / "nerd.pth")
    torch.save(torch_sd, cfg["ckpt"])
    again = load_params(cfg, get_model("nerd_rain", **TINY))
    for k, v in sd.items():
        assert torch.equal(again.state_dict()[k], v), k


def _save_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def test_cli_test_matches_jax(tmp_path):
    """Two derain pairs, 24x20 and 20x28: the port pads both to 32x32 by
    its nerd_rain default, the JAX CLI by ``--pad_multiple 16``."""
    rng = np.random.default_rng(6)
    data = tmp_path / "data"
    for i, (h, w) in enumerate([(24, 20), (20, 28)]):
        gt = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        noisy = np.clip(gt + rng.standard_normal(gt.shape) * 20, 0, 255)
        _save_png(str(data / f"deraining/Rain100L/target/{i}.png"), gt)
        _save_png(str(data / f"deraining/Rain100L/input/{i}.png"),
                  noisy.astype(np.uint8))
    params, _, _ = _jax_model()
    ckpt = str(tmp_path / "w.npz")
    save_params_npz(ckpt, params)
    out = {}
    for name, main, extra in (
            ("jax", jax_test.main, ["--pad_multiple", "16"]),
            ("port", port_test.main, ["--device", "cpu"])):
        od = str(tmp_path / name)
        main(["--model", "nerd_rain", "--ckpt", ckpt, "--data_file_dir",
              str(data), "--benchmarks", "derain", "--output_dir", od]
             + TINY_ARGS + extra)
        with open(os.path.join(od, "results.json")) as f:
            out[name] = json.load(f)["derain"]
    assert out["port"]["n"] == out["jax"]["n"] == 2
    assert abs(out["port"]["psnr"] - out["jax"]["psnr"]) <= 1e-4
    assert abs(out["port"]["ssim"] - out["jax"]["ssim"]) <= 1e-5
