"""The port's benchmark evaluation (eval/benchmarks.py, cli/test.py) and its
inference CLI (cli/infer.py) against the JAX package's.

A narrow Restormer (dim 16, one block a level, one refinement block, fp32)
is loaded in both packages from one JAX ``save_params_npz`` file (the JAX
module's own init, seeded), and both CLIs score the same PIL-written
benchmark tree (seeded numpy images in the JAX layout of
``eval/benchmarks.py``). Tolerances: PSNR 1e-4 dB, SSIM 1e-5 (the metric
tolerances of tests/test_torch_metrics.py; the two models' fp32 outputs
differ by ~1e-6, their conv sums running in another order). Saved 8-bit
images: equal pixels where both packages compute the same bits (a
pointwise stand-in model); through the model, at most one level apart at
a value whose fp32 output lies on a rounding boundary.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_restoration_tpu.cli import infer as jax_infer
from image_restoration_tpu.cli import test as jax_test
from image_restoration_tpu.cli.train import build_model as jax_build_model
from image_restoration_tpu.eval import benchmarks as JB
from image_restoration_tpu.models.restormer import Restormer as JRestormer
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu.utils.options import parse_options as jax_parse_options
from image_restoration_tpu_torch.cli import infer as port_infer
from image_restoration_tpu_torch.cli import test as port_test
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.eval import benchmarks as TB
from image_restoration_tpu_torch.utils.options import parse_options

PSNR_TOL = 1e-4
SSIM_TOL = 1e-5
TINY = ["--model", "restormer", "--fp32",
        "--set", "model_kwargs.dim=16",
        "--set", "model_kwargs.num_blocks=(1,1,1,1)",
        "--set", "model_kwargs.num_refinement_blocks=1"]


def _save(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr.astype(np.uint8)).save(path)


def _rand(rng, h, w):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def _degrade(rng, img):
    noisy = img.astype(np.float64) + rng.standard_normal(img.shape) * 20
    return np.clip(noisy, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Benchmark folders (odd sizes: 40x36 pads to 40x40, 36x44 to 40x48;
    GoPro's 70x50 buckets to 128x64) and the weights file."""
    rng = np.random.default_rng(12)
    root = tmp_path_factory.mktemp("bench")
    d = root / "data"
    for i, (h, w) in enumerate([(40, 36), (36, 44)]):
        gt = _rand(rng, h, w)
        _save(str(d / f"deraining/Rain100L/target/{i}.png"), gt)
        _save(str(d / f"deraining/Rain100L/input/{i}.png"), _degrade(rng, gt))
        gt = _rand(rng, h, w)
        _save(str(d / f"dehazing/SOTS/outdoor/clear/{i:04d}.png"), gt)
        _save(str(d / f"dehazing/SOTS/outdoor/hazy/{i:04d}_0.8_0.2.png"),
              _degrade(rng, gt))
        _save(str(d / f"denoising/bsd68/{i}.png"), _rand(rng, h, w))
        hr = _rand(rng, h, w)
        _save(str(d / f"sr/Set5/HR/im{i}.png"), hr)
        _save(str(d / f"sr/Set5/LR_bicubic/X4/im{i}x4.png"),
              hr[: h // 4 * 4 : 4, : w // 4 * 4 : 4])
    gt = _rand(rng, 70, 50)
    _save(str(d / "deblurring/GoPro/test/target/0.png"), gt)
    _save(str(d / "deblurring/GoPro/test/input/0.png"), _degrade(rng, gt))
    for folder in ["low", "low_haze"]:
        gt = _rand(rng, 70, 70)
        _save(str(d / "cdd11/test/clear/0.png"), gt)
        _save(str(d / f"cdd11/test/{folder}/0.png"), _degrade(rng, gt))

    net = JRestormer(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
    params = jax.jit(net.init)(jax.random.PRNGKey(1),
                               jnp.zeros((1, 64, 64, 3)))
    ckpt = str(root / "w.npz")
    save_params_npz(ckpt, params["params"])
    return {"root": root, "data": str(d), "ckpt": ckpt}


def _run_both(tree, tag, extra):
    """Both CLIs on the same arguments; returns both results.json dicts
    (each also checked against what its main returned)."""
    out = {}
    for name, main, dev in (("jax", jax_test.main, []),
                            ("port", port_test.main, ["--device", "cpu"])):
        od = str(tree["root"] / f"{tag}_{name}")
        argv = TINY + dev + ["--ckpt", tree["ckpt"], "--data_file_dir",
                             tree["data"], "--output_dir", od] + [
            a.replace("@", od) for a in extra]
        ret = main(argv)
        with open(os.path.join(od, "results.json")) as f:
            out[name] = json.load(f)
        assert out[name] == json.loads(json.dumps(ret))
    return out["jax"], out["port"]


def _same_results(want, got):
    assert got.keys() == want.keys()
    for b in want:
        assert got[b].keys() == want[b].keys() == {"psnr", "ssim", "n"}
        assert got[b]["n"] == want[b]["n"]
        assert abs(got[b]["psnr"] - want[b]["psnr"]) <= PSNR_TOL, b
        assert abs(got[b]["ssim"] - want[b]["ssim"]) <= SSIM_TOL, b


@pytest.mark.parametrize("extra", [
    ["--benchmarks", "derain", "dehaze"],
    ["--benchmarks", "denoise_25"],
    ["--benchmarks", "deblur"],
    ["--benchmarks", "cdd11"],
    ["--mode", "3"],
], ids=["derain_dehaze", "denoise_25", "deblur_bucket", "cdd11", "mode3"])
def test_cli_test_matches_jax(tree, extra):
    want, got = _run_both(tree, extra[-1], extra)
    _same_results(want, got)
    if extra[0] == "--mode":
        assert list(got) == ["denoise_25", "derain", "dehaze"]
    for b, r in got.items():
        assert np.isfinite(r["psnr"]) and 0 < r["ssim"] <= 1, b


def _pngs(d):
    return {n: np.asarray(Image.open(os.path.join(d, n)))
            for n in sorted(os.listdir(d))}


def test_cli_test_save_images_and_tile(tree):
    """``--tile 16 --save_images``: the same results and the same PNGs (at
    most one level apart where the two fp32 outputs straddle a rounding
    boundary)."""
    want, got = _run_both(tree, "tiled", ["--benchmarks", "derain",
                                          "--tile", "16", "--save_images",
                                          "@/imgs"])
    _same_results(want, got)
    j = _pngs(str(tree["root"] / "tiled_jax/imgs/derain"))
    t = _pngs(str(tree["root"] / "tiled_port/imgs/derain"))
    assert list(t) == list(j) == ["0.png", "1.png"]
    for n in j:
        diff = np.abs(t[n].astype(int) - j[n].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, n


@pytest.mark.parametrize("tile", [None, 16], ids=["padded", "tiled"])
def test_run_benchmark_saves_equal_pixels(tree, tile):
    """A pointwise stand-in computes the same bits in both packages, so the
    saved PNGs (rounded half up) and the scores must be equal."""
    d = tree["root"] / f"stand_in_{tile}"
    r_j = JB.run_benchmark("derain", lambda x: 0.9 * x + 0.05, tree["data"],
                           tile=tile, save_dir=str(d / "jax"))
    r_t = TB.run_benchmark("derain", lambda x: 0.9 * x + 0.05, tree["data"],
                           tile=tile, save_dir=str(d / "port"), device="cpu")
    assert (r_t.name, r_t.n) == (r_j.name, r_j.n) == ("derain", 2)
    assert abs(r_t.psnr - r_j.psnr) <= PSNR_TOL
    assert abs(r_t.ssim - r_j.ssim) <= SSIM_TOL
    j, t = _pngs(str(d / "jax/derain")), _pngs(str(d / "port/derain"))
    assert list(t) == list(j)
    for n in j:
        np.testing.assert_array_equal(t[n], j[n])


def test_run_benchmark_sr_x4(tree):
    """sr_set5_x4: Y channel, crop_border = 4, scale 4, with a nearest x4
    upsampling stand-in for the SR model."""
    r_j = JB.run_benchmark(
        "sr_set5_x4",
        lambda x: jnp.repeat(jnp.repeat(x, 4, axis=1), 4, axis=2),
        tree["data"])
    r_t = TB.run_benchmark(
        "sr_set5_x4",
        lambda x: x.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3),
        tree["data"], device="cpu")
    assert r_t.n == r_j.n == 2
    assert abs(r_t.psnr - r_j.psnr) <= PSNR_TOL
    assert abs(r_t.ssim - r_j.ssim) <= 1e-4  # ssim_yc's 0-255 tolerance


def test_registry_matches_jax():
    assert list(TB.BENCHMARKS) == list(JB.BENCHMARKS)
    for name, spec in JB.BENCHMARKS.items():
        assert TB.BENCHMARKS[name].eval_kw == spec.eval_kw, name
    assert TB.MODE_TO_BENCHMARKS == JB.MODE_TO_BENCHMARKS
    with pytest.raises(KeyError, match="sr_set5_x4"):
        TB.run_benchmark("nope", lambda x: x, "/nonexistent")
    ds = [{"lq": np.zeros((8, 8, 3), np.float32),
           "gt": np.zeros((8, 8, 3), np.float32), "name": "a.png"}]
    with pytest.raises(ValueError, match="bucket"):
        TB.evaluate(lambda x: x, ds, pad_multiple=7, bucket=64, device="cpu")


def test_cli_test_refuses_niqe_and_lpips(tree):
    """``--unpaired`` scores NIQE (``test_cli_unpaired_matches_jax``) and
    refuses to run without the pristine parameters, naming
    ``--niqe_params`` (the repo ships none); ``--lpips_ckpt`` scores LPIPS
    (tests/test_torch_perceptual.py), and a checkpoint that is not there
    is an error, not a missing column."""
    args = TINY + ["--device", "cpu", "--ckpt", tree["ckpt"]]
    src = os.path.join(tree["data"], "deraining/Rain100L/input")
    with pytest.raises(FileNotFoundError, match="niqe_params"):
        port_test.main(args + ["--unpaired", "--lq_dir", src, "--output_dir",
                               str(tree["root"] / "unpaired_none")])
    with pytest.raises(FileNotFoundError):
        port_test.main(args + ["--lpips_ckpt", str(tree["root"] / "no.pth")])


def test_cli_unpaired_matches_jax(tree):
    """Both CLIs' ``--unpaired`` on one PIL-written folder of two 192x192
    images with synthetic pristine parameters (``tests/seeding.py``
    ``write_niqe_params``, through ``--niqe_params``): the same
    ``results.json`` keys, the inputs' NIQE equal exactly (the same numpy
    images through the same host metric), the outputs' within 1e-3
    relative: the two restorations differ by ~1e-6, and NIQE's AGGD fit
    picks from a table with a step of 0.001 (tests/test_torch_niqe_fid.py
    ``test_niqe_table_step``)."""
    from seeding import write_niqe_params

    rng = np.random.default_rng(13)
    src = tree["root"] / "unpaired_in"
    yy, xx = np.mgrid[0:192, 0:192] / 192.0
    for i in range(2):
        img = 0.5 + 0.3 * np.sin(5 * xx + 3 * yy + i)[..., None] + \
            0.08 * rng.standard_normal((192, 192, 3))
        _save(str(src / f"{i}.png"), np.clip(img * 255, 0, 255))
    pris = write_niqe_params(str(tree["root"] / "pris.npz"), seed=4)
    res = {}
    for name, main, dev in (("jax", jax_test.main, []),
                            ("port", port_test.main, ["--device", "cpu"])):
        od = str(tree["root"] / f"unpaired_{name}")
        got = main(TINY + dev + ["--ckpt", tree["ckpt"], "--unpaired",
                                 "--lq_dir", str(src), "--niqe_params", pris,
                                 "--output_dir", od])
        with open(os.path.join(od, "results.json")) as f:
            res[name] = json.load(f)
        assert res[name] == got
    assert set(res["port"]["unpaired"]) == set(res["jax"]["unpaired"]) == {
        "n", "niqe", "niqe_input"}
    assert res["port"]["unpaired"]["n"] == res["jax"]["unpaired"]["n"] == 2
    assert res["port"]["unpaired"]["niqe_input"] == \
        res["jax"]["unpaired"]["niqe_input"]
    np.testing.assert_allclose(res["port"]["unpaired"]["niqe"],
                               res["jax"]["unpaired"]["niqe"], rtol=1e-3)
    assert parse_options(["--niqe_params", pris])["niqe_params"] == pris


@pytest.mark.parametrize("tile", [None, 16], ids=["padded", "tiled"])
def test_cli_infer_lq_dir(tree, tile):
    """``--lq_dir`` in place of ``--input``, whole-image and tiled: the same
    files and pixels as the JAX CLI (rounded half to even by both; at most
    one level apart on a rounding boundary)."""
    src = os.path.join(tree["data"], "deraining/Rain100L/input")
    extra = ["--tile", str(tile)] if tile else []
    outs = {}
    for name, main, dev in (("jax", jax_infer.main, []),
                            ("port", port_infer.main, ["--device", "cpu"])):
        od = str(tree["root"] / f"infer_{tile}_{name}")
        paths = main(TINY + dev + extra + ["--ckpt", tree["ckpt"], "--lq_dir",
                                           src, "--output_dir", od])
        assert [os.path.basename(p) for p in paths] == ["0.png", "1.png"]
        outs[name] = _pngs(od)
    for n, j in outs["jax"].items():
        diff = np.abs(outs["port"][n].astype(int) - j.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, n


def test_cli_infer_tile_matches_restore_fn(tree):
    """``make_restore_fn`` with ``tile``: the windows of a 40x48 image
    (remainders in both directions) restored as one batch equal the JAX
    restore within 1e-5."""
    argv = TINY + ["--ckpt", tree["ckpt"], "--tile", "16"]
    cfg = parse_options(argv + ["--device", "cpu"])
    model = port_test.load_params(cfg, build_model(cfg))
    jc = jax_parse_options(argv)
    jnet = jax_build_model(jc)
    params = jax_test.load_params(jc, jnet, jnp.zeros((1, 64, 64, 3)))
    img = np.random.default_rng(3).random((40, 44, 3)).astype(np.float32)
    got = port_infer.make_restore_fn(cfg, model)(img)
    want = jax_infer.make_restore_fn(jc, jnet, params)(img)
    assert got.shape == want.shape == (40, 44, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cli_infer_video_needs_ffmpeg(tree, monkeypatch):
    video = tree["root"] / "clip.mp4"
    video.write_bytes(b"\x00" * 16)
    monkeypatch.setattr(port_infer, "_ffmpeg", lambda: None)
    with pytest.raises(SystemExit, match="ffmpeg"):
        port_infer.main(TINY + ["--device", "cpu", "--input", str(video),
                                "--output_dir", str(tree["root"] / "vid")])
    with pytest.raises(SystemExit, match="required"):
        port_infer.main(TINY + ["--device", "cpu"])


def test_forward_unwraps_tuple():
    """A model that returns (out, aux) is scored and restored on ``out``,
    as the JAX CLIs unwrap it."""

    class Pair(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, x):
            return x * self.w * 0.5, torch.zeros(())

    fn = port_test.make_eval_fn(Pair())
    x = torch.rand(1, 3, 8, 8)
    torch.testing.assert_close(fn(x), 0.5 * x)
    img = np.random.default_rng(1).random((9, 10, 3)).astype(np.float32)
    out = port_infer.make_restore_fn({"pad_multiple": 8, "model": "x"},
                                     Pair())(img)
    np.testing.assert_allclose(out, 0.5 * img, rtol=0, atol=1e-7)
