"""The port's MWFormer (``models/mwformer.py``), its style recipe and its
two-stage training against the JAX package's, on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``),
the tree goes into the port through ``state_dict_from_jax``, and both run
the same seeded numpy inputs in fp32 (JAX at "highest" matmul precision,
torch with TF32 off); the port takes NCHW images and (B, N, C) tokens, the
JAX package NHWC images and the same tokens.

Tolerance: rtol=1e-4, atol=1e-5 for every module; the whole models and
the train step at atol=1e-5 x the largest |value| and rtol=1e-4.

* FilmBlock, HyperMlp (the per-sample kernels of a batch of 2),
  HyperSRAttn (sr 1 and 2), MWBlock (hyper and plain attention),
  ``gram_upper_vec``, StyleFilter's embedding, the backbone with a
  standard-normal style vector.
* MWFormer end to end (a narrow configuration) at 64x64. Its random
  StyleFilter sums Gram matrices over the pixels into a vector of ~4e2,
  which the backbone's hypernets turn into saturated softmaxes that
  amplify fp32 rounding ~1e4-fold; the test scales ``out1_fc`` so the
  vector is O(1), as a trained filter's is.
* The key maps against JAX's.
* One SGD step of ``--recipe mwformer_style`` (SupCon over the embeddings
  with ``de_id`` labels) against JAX's ``make_train_step``.
* The two stages through ``cli/train.py`` ``main`` on the CPU:
  ``mwformer_style`` takes a step on a two-task tree (de_id 0 and 1),
  then ``mwformer --style_ckpt`` (the run's checkpoint directory) takes a
  step with the loaded filter bit-equal before and after; a
  reference-layout ``.pth`` (``encoder.block1.0...``) loads too.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (ATOL, RTOL, init_shapes, load, nchw, nhwc, pair,
                           randomized, train_step_pair)
from moe_parity import compiled
from PIL import Image

from image_restoration_tpu.models import mwformer as jm
from image_restoration_tpu_torch.cli import train as train_cli
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import mwformer as tm


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float()
    got = nhwc(got) if got.dim() == 4 else got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _vec(rng, b=2):
    return rng.standard_normal((b, tm.VEC_DIM)).astype(np.float32)


def test_film_block():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    vec = _vec(rng)
    vmap = np.broadcast_to(vec[:, None, None], (2, 6, 5, tm.VEC_DIM)).copy()
    jmod = jm.FilmBlock(16)
    params = randomized(init_shapes(jmod, x, vmap)["params"], rng)
    tmod = load(tm.FilmBlock(8, 16), params)
    with torch.no_grad():
        got = tmod(nchw(x), torch.from_numpy(vec))
    _close(got, jmod.apply({"params": params}, x, vmap))


TOKEN_MODULES = {
    "mlp": (lambda: jm.HyperMlp(32, 16), lambda: tm.HyperMlp(16, 32, 16)),
    "attn_sr1": (lambda: jm.HyperSRAttn(16, 2, 1),
                 lambda: tm.HyperSRAttn(16, 2, 1)),
    "attn_sr2": (lambda: jm.HyperSRAttn(16, 2, 2),
                 lambda: tm.HyperSRAttn(16, 2, 2)),
    "block_hyper": (lambda: jm.MWBlock(16, 2, 2.0, 2, hyper_attn=True),
                    lambda: tm.MWBlock(16, 2, 2.0, 2, hyper_attn=True)),
    "block_sr": (lambda: jm.MWBlock(16, 2, 2.0, 2),
                 lambda: tm.MWBlock(16, 2, 2.0, 2)),
}


@pytest.mark.parametrize("name", sorted(TOKEN_MODULES))
def test_token_modules(name):
    """A batch of 2 whose style vectors, and so whose generated kernels
    and projections, differ."""
    rng = np.random.default_rng(1)
    h, w = 6, 5
    t = rng.standard_normal((2, h * w, 16)).astype(np.float32)
    vec = _vec(rng)
    jmod, tmod = (f() for f in TOKEN_MODULES[name])
    shapes = jax.eval_shape(functools.partial(jmod.init, h=h, w=w),
                            jax.random.PRNGKey(0), t, vec=vec)
    params = randomized(shapes["params"], rng)
    load(tmod, params).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(t), h, w, torch.from_numpy(vec))
    _close(got, jmod.apply({"params": params}, t, h, w, vec))


def test_gram_upper_vec():
    rng = np.random.default_rng(2)
    f = rng.standard_normal((2, 5, 4, 6)).astype(np.float32)
    got = tm.gram_upper_vec(nchw(f))
    assert got.shape == (2, 21)
    _close(got, jm.gram_upper_vec(jnp.asarray(f)))


STYLE = dict(embed_dims=(16, 32), depths=(1, 1))


def test_style_filter_embedding():
    rng = np.random.default_rng(3)
    x = rng.random((2, 64, 48, 3), dtype=np.float32)
    want, got = pair(jm.StyleFilter(**STYLE), tm.StyleFilter(**STYLE), rng,
                     x)
    assert got.shape == (2, tm.VEC_DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


TINY = dict(embed_dims=(16, 32, 40, 64), num_heads=(1, 2, 2, 2),
            depths=(1, 1, 1, 1), dec_depth=1, dec_heads=2)


def test_backbone():
    rng = np.random.default_rng(4)
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    vec = _vec(rng)
    jnet = jm.MWFormerBackbone(**TINY)
    params = randomized(init_shapes(jnet, x, vec)["params"], rng)
    want = np.asarray(compiled(lambda p, a, v: jnet.apply({"params": p}, a,
                                                          v), params, x, vec))
    tnet = load(get_model("mwformer_backbone", **TINY), params,
                tm.mwformer_key_map).eval()
    with torch.no_grad():
        got = tnet(nchw(x), torch.from_numpy(vec))
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


FULL = dict(TINY, style_embed_dims=(16, 32), style_depths=(1, 1))


def test_whole_model_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    jnet = jm.MWFormer(**FULL)
    params = randomized(init_shapes(jnet, x)["params"], rng)
    style = load(tm.StyleFilter(**STYLE), params["style_filter"]).eval()
    with torch.no_grad():
        scale = float(style(nchw(x)).abs().max())
    fc = params["style_filter"]["out1_fc"]
    fc.update({k: v / scale for k, v in fc.items()})
    want = np.asarray(compiled(lambda p, a: jnet.apply({"params": p}, a),
                               params, x))
    tnet = load(get_model("mwformer", **FULL), params,
                tm.mwformer_key_map).eval()
    with torch.no_grad():
        got = tnet(nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_key_maps():
    for key in ("Tenc.mini_patch_embed4.proj.weight",
                "convtail.conv_output.conv2d.weight"):
        assert tm.mwformer_key_map(key) is None
        assert jm.mwformer_key_map(key) is None
    for key in ("encoder.block1.0.attn.q.weight",
                "style_filter1.hidden.weight", "style_filter2.output.bias",
                "encoder.patch_embed1.proj.weight"):
        assert tm.style_filter_key_map(key) == jm.style_filter_key_map(key)
        assert tm.style_filter_key_map(key) in get_model(
            "mwformer_style").state_dict()


def test_style_train_step_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.random((4, 64, 64, 3), dtype=np.float32)
    jnet = jm.StyleFilter(**STYLE)
    params = randomized(init_shapes(jnet, x)["params"], rng)
    tnet = load(get_model("mwformer_style", **STYLE), params)
    batch = {"lq": x, "gt": x, "de_id": np.array([0, 1, 0, 1], np.int32)}
    logs = train_step_pair(jnet, tnet, params, batch, "mwformer_style")
    assert set(logs) == {"supcon", "total"}


def _tree(root):
    """Two tasks (denoise and derain: de_id 0 and 1), two images each."""
    rng = np.random.default_rng(7)
    for i in range(2):
        clean = (rng.random((72, 72, 3)) * 255).astype(np.uint8)
        Image.fromarray(clean).save(root / f"clean{i}.png")
        noisy = np.clip(clean + rng.integers(-30, 30, clean.shape), 0, 255)
        for sub, img in (("gt", clean), ("rainy", noisy)):
            path = root / "deraining" / "RainTrainL" / sub / f"norain-{i}.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(path)
    (root / "denoising").mkdir()
    for i in range(2):
        (root / f"clean{i}.png").rename(root / "denoising" / f"c{i}.png")


def _main(root, tmp_path, name, *extra):
    argv = ["--device", "cpu", "--data_file_dir", str(root), "--de_type",
            "denoise_15", "derain", "--patch_size", "64", "--batch_size",
            "4", "--warmup_epochs", "0", "--ckpt_dir", str(tmp_path),
            "--name", name, "--save_every", "0", "--log_every", "1",
            "--num_workers", "1", "--fp32", *extra]
    state = train_cli.main(argv, max_steps_override=1)
    logged = [json.loads(line) for line in open(tmp_path / name /
                                                "metrics.jsonl")]
    return state, {k: v for e in logged for k, v in e.items()}


def test_two_stage_training(tmp_path):
    root = tmp_path / "aio"
    root.mkdir()
    _tree(root)
    style_args = ["--set", "model_kwargs.embed_dims=(16,32)", "--set",
                  "model_kwargs.depths=(1,1)"]
    _, logs = _main(root, tmp_path, "s1", "--model", "mwformer_style",
                    "--recipe", "mwformer_style", *style_args)
    assert np.isfinite(logs["train/supcon"])
    ckpt_dir = tmp_path / "s1" / "ckpt"
    stage1 = torch.load(ckpt_dir / "1.pth", weights_only=True)["params"]
    full_args = [
        "--model", "mwformer", "--set", "model_kwargs.embed_dims=(16,32,40,64)",
        "--set", "model_kwargs.num_heads=(1,2,2,2)", "--set",
        "model_kwargs.depths=(1,1,1,1)", "--set", "model_kwargs.dec_depth=1",
        "--set", "model_kwargs.dec_heads=2", "--set",
        "model_kwargs.style_embed_dims=(16,32)", "--set",
        "model_kwargs.style_depths=(1,1)"]
    state, logs = _main(root, tmp_path, "s2", *full_args, "--style_ckpt",
                        str(ckpt_dir))
    assert np.isfinite(logs["train/l1"])
    after = state.model.state_dict()
    for k, v in stage1.items():
        assert torch.equal(after[f"style_filter.{k}"], v), k
    init = train_cli.build_model({"model": "mwformer", "bf16": False,
                                  "model_kwargs": dict(
                                      embed_dims=(16, 32, 40, 64),
                                      num_heads=(1, 2, 2, 2),
                                      depths=(1, 1, 1, 1), dec_depth=1,
                                      dec_heads=2,
                                      style_embed_dims=(16, 32),
                                      style_depths=(1, 1))},
                                 torch.device("cpu")).state_dict()
    assert not torch.equal(after["backbone.clean.weight"],
                           init["backbone.clean.weight"])

    # a reference-layout .pth of the filter loads through the key map
    ref = {k.replace("encoder_", "encoder.").replace(
        "style_filter1_", "style_filter1.").replace(
        "style_filter2_", "style_filter2."): v for k, v in stage1.items()}
    torch.save({"state_dict": ref}, tmp_path / "ref.pth")
    model = train_cli.load_style_filter(
        {"style_ckpt": str(tmp_path / "ref.pth")},
        get_model("mwformer", **FULL))
    for k, v in stage1.items():
        assert torch.equal(model.state_dict()[f"style_filter.{k}"], v), k
