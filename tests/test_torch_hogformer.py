"""The port's HOGformer (``models/hogformer.py``) and its training recipe
against the JAX package's, on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``),
the tree goes into the port through ``state_dict_from_jax``, and both run
the same seeded numpy inputs in fp32 (JAX at "highest" matmul precision,
torch with TF32 off); the port takes NCHW, the JAX package NHWC. JAX runs
its default polyphase ``FFN_DIFF`` (``IR_HOG_FFN=fold``: the pixel shuffle
folded into ``project_in``) and one-hot permutation matmuls; the port the
reference's order, so these tests hold the two orders to one function.

Tolerance: rtol=1e-4, atol=1e-5 for every module; the whole model and the
train step at atol=1e-5 x the largest |value| and rtol=1e-4. bf16: the
port's bf16 output against JAX's fp32 within 3x the JAX bf16 model's
error against it (max and mean).

* The sort: ``_argsort`` against ``jnp.argsort`` on keys with ties (both
  stable: ties keep their index order), the inverse permutation, the
  patch split and merge with padding.
* FFN_DIFF with and without biases (JAX folds a bias through a ones-map
  conv); TransformerBlock (WithBias and BiasFree); SkipPatchEmbed.
* Attention_DHOGSA with 1 head (no global sort), 2 and 4 heads at 13x11
  (143 tokens padded to the heads, patches padded to 8), and with tied
  sort keys: a zero region gives equal keys in the within-patch sort and
  the global sort, and the order the port keeps is JAX's.
* The whole model (a narrow configuration) at 24x16. Where a sort key
  or an orientation sits within fp32 rounding of a tie or a bin edge, the
  two packages may order differently (JAX's own jitted and op-by-op
  forwards do); the model tests assert the port's least margins, as the
  MoE tests assert their routers' gaps. bf16 is held on the card
  (tests/test_torch_family_cuda.py): bf16 keys tie often, and the
  packages break near-ties differently.
* One SGD step of ``--recipe hogformer`` (L1 + Pearson + HOG) against
  JAX's ``make_train_step``; one CPU step through ``cli/train.py``.
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

from image_restoration_tpu.models import hogformer as jh
from image_restoration_tpu_torch.cli import train as train_cli
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import hogformer as th


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _x(rng, c, h=13, w=11, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


def test_sort_and_permutations():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 4, (3, 64)).astype(np.float32)  # many ties
    idx = th._argsort(torch.from_numpy(keys))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jnp.argsort(keys)))
    inv = th._inverse_permutation(idx)
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(jh._inverse_permutation(jnp.asarray(idx))))
    np.testing.assert_array_equal(
        torch.gather(idx, 1, inv).numpy(), np.tile(np.arange(64), (3, 1)))
    x = _x(rng, 5)
    want, info = jh._split_patches(jnp.asarray(x), 8)
    got, tinfo = th._split_patches(nchw(x), 8)
    assert info == tinfo == (13, 11, 2, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(nhwc(th._merge_patches(got, 8, tinfo)), x)


@pytest.mark.parametrize("bias", [False, True])
def test_ffn_diff(bias):
    rng = np.random.default_rng(1)
    want, got = pair(jh.FFN_DIFF(12, use_bias=bias),
                     th.FFN_DIFF(12, use_bias=bias), rng, _x(rng, 12))
    _close(got, want)


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_attention(heads):
    rng = np.random.default_rng(2)
    want, got = pair(jh.Attention_DHOGSA(16, heads),
                     th.Attention_DHOGSA(16, heads), rng, _x(rng, 16))
    _close(got, want)


def test_attention_tied_sort_keys():
    """A zero region: its pixels' within-patch keys are all equal (no
    gradient: mag sqrt(1e-6), bin 4), and so are the global sort's keys
    of the interior of v's zero region."""
    rng = np.random.default_rng(3)
    x = _x(rng, 16, 16, 16)
    x[:, :10, :10] = 0.0
    jmod, tmod = jh.Attention_DHOGSA(16, 2), th.Attention_DHOGSA(16, 2)
    want, got = pair(jmod, tmod, rng, x)
    _close(got, want)
    # the ties: recompute the two sorts' keys the port used
    with torch.no_grad():
        xt = nchw(x)
        gx, gy = th._sobel(xt[:, :8])
        mag = torch.sqrt(gx * gx + gy * gy + 1e-6)
        bins = (((torch.atan2(gy, gx) + np.pi) / (2 * np.pi) * 9)
                .to(torch.int32) % 9).float()
        pm, pb = th._split_patches(mag, 8)[0], th._split_patches(bins, 8)[0]
        patch_keys = (pm * (pb + 1)).sum(2)
        qkv = tmod.qkv_dwconv(tmod.qkv(xt))
        gxv, gyv = th._sobel(qkv[:, 64:])
        glob = (torch.sqrt(gxv * gxv + gyv * gyv + 1e-6)
                * (torch.atan2(gyv, gxv) + np.pi) / (2 * np.pi)).sum(1)
    for k in (patch_keys[0, 0], glob[0].flatten()):
        assert len(torch.unique(k)) < len(k) - 10  # ties
        np.testing.assert_array_equal(th._argsort(k).numpy(),
                                      np.asarray(jnp.argsort(k.numpy())))


@pytest.mark.parametrize("ln_type", ["WithBias", "BiasFree"])
def test_transformer_block(ln_type):
    rng = np.random.default_rng(4)
    want, got = pair(jh.TransformerBlock(12, 2, ln_type=ln_type),
                     th.TransformerBlock(12, 2, ln_type=ln_type), rng,
                     _x(rng, 12, 16, 8))
    _close(got, want)


def test_skip_patch_embed():
    rng = np.random.default_rng(5)
    want, got = pair(jh.SkipPatchEmbed(3), th.SkipPatchEmbed(3), rng,
                     _x(rng, 3))
    _close(got, want)


TINY = dict(dim=12, num_blocks=(1, 1, 1, 1), num_refinement_blocks=0,
            heads=(1, 2, 4, 8))
HW = (24, 16)
# Least margins, in the port's forward, for the two packages' sorts to
# agree: of every scaled orientation ((atan2 + pi) / 2pi * 9) from a bin
# edge (fp32 rounding moves it by ~3e-7: an ulp of atan2 and the Sobel
# sums), and of every sort key from the next larger one, relative to the
# row's largest (sums over the channels, ~1e-7 apart between the
# packages). Exact ties (zero padding) sort in index order in both.
BIN_MARGIN_MIN, KEY_GAP_MIN = 1e-5, 1e-6


def _assert_margins(seen):
    least = min(seen["bin"]), min(seen["key"])
    assert least[0] > BIN_MARGIN_MIN and least[1] > KEY_GAP_MIN, least


@pytest.fixture
def margins(monkeypatch):
    """The least bin and key margins of the port's forwards while the
    fixture is active."""
    seen = {"bin": [np.inf], "key": [np.inf]}
    argsort, ori_bin = th._argsort, th._ori_bin

    def record_sort(key):
        k = torch.sort(key.detach().float(), -1).values
        gap = (k[..., 1:] - k[..., :-1]) / k.abs().amax(-1, keepdim=True)
        seen["key"].append(float(gap[gap > 0].min()) if (gap > 0).any()
                           else np.inf)
        return argsort(key)

    def record_bin(gx, gy, n_bins):
        s = (torch.atan2(gy, gx) + np.pi) / (2 * np.pi) * n_bins
        seen["bin"].append(float((s - s.round()).abs().min().detach()))
        return ori_bin(gx, gy, n_bins)

    monkeypatch.setattr(th, "_argsort", record_sort)
    monkeypatch.setattr(th, "_ori_bin", record_bin)
    return seen


@functools.lru_cache(maxsize=None)
def _jax_model():
    rng = np.random.default_rng(13)
    x = rng.random((2, *HW, 3), dtype=np.float32)
    jnet = jh.HOGformer(**TINY)
    params = randomized(init_shapes(jnet, jnp.asarray(x))["params"], rng)
    want = compiled(lambda p, a: jnet.apply({"params": p}, a), params,
                    jnp.asarray(x))
    return params, x, np.asarray(want, np.float32)


def _port(params, dtype=None):
    return load(get_model("hogformer", **TINY, dtype=dtype).eval(), params)


def test_whole_model_matches_jax(margins):
    """24x16: the latent's 3x2 = 6 tokens pad to 8 for its 8 heads, and
    the patches of levels 2-4 pad to 8."""
    params, x, want = _jax_model()
    with torch.inference_mode():
        got = _port(params)(nchw(x))
    _assert_margins(margins)
    assert got.dtype == torch.float32 and got.shape == (2, 3, *HW)
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_train_step_matches_jax(margins):
    params, _, _ = _jax_model()
    rng = np.random.default_rng(14)
    gt = rng.random((2, *HW, 3)).astype(np.float32)
    lq = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1).astype(
        np.float32)
    logs = train_step_pair(jh.HOGformer(**TINY), _port(params), params,
                           {"lq": lq, "gt": gt}, "hogformer")
    _assert_margins(margins)
    assert set(logs) == {"l_pix", "l_pear", "l_hog", "total"}


def test_trains_through_main(tmp_path):
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
            "1", "--fp32", "--model", "hogformer", "--recipe", "hogformer",
            "--set", "model_kwargs.dim=12", "--set",
            "model_kwargs.num_blocks=(1,1,1,1)", "--set",
            "model_kwargs.num_refinement_blocks=1"]
    assert train_cli.main(argv, max_steps_override=1).step == 1
    logged = [json.loads(line) for line in open(tmp_path / "t" /
                                                "metrics.jsonl")]
    assert all(np.isfinite(logged[0][f"train/{k}"])
               for k in ("l_pix", "l_pear", "l_hog", "total"))
