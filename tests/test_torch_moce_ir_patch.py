"""The port's patch-routed MoCE-IR (``models/moce_ir_patch.py``) against
the JAX package's, on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``),
the tree goes into the port through ``state_dict_from_jax``, and both run
the same seeded numpy inputs in fp32 (JAX at "highest" matmul precision,
torch with TF32 off); the port takes NCHW, the JAX package NHWC.

Tolerance: rtol=1e-4, atol=1e-5 for every module; the whole model at
atol=1e-5 x the largest |output| (random weights give outputs near 10;
the dense mixture over every token of a decoder level sums four experts'
fp32 rounding) and rtol=1e-4. Every token's gap between its 2nd and 3rd
softmax score must exceed 1e-5 (fp32 rounding is ~1e-7), so no pick can
flip between the packages.

* ``patch_split``/``patch_merge``: the JAX token order, and a round trip.
* Modules: PatchRoutingFunction (per token: the strided fp32 conv gate
  plus the frequency gate), PatchAdapterLayer with every expert on every
  16x16 token (the patch-32 expert pads each token), PatchDecoderBlock.
* The whole model at dim 16, one block a level, 40x36 (padded to 32 inside)
  and 32x32 at batch 2; a JAX ``.npz`` through ``load_params``;
  ``cli/infer.py --model moce_ir_patch`` on the CPU.
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
    kth_gap,
    load,
    nchw,
    nhwc,
    pair,
    randomized,
    routing_gaps,
)
from PIL import Image

from image_restoration_tpu.models import moce_ir_patch as jp
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import moce_ir_patch as tp


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _to_torch(x):
    return nchw(x) if np.ndim(x) == 4 else torch.from_numpy(np.asarray(x))


def _x(rng, c, h=32, w=48, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


def test_patch_split_and_merge():
    x = _x(np.random.default_rng(0), 3)
    want = np.asarray(jp.patch_split(jnp.asarray(x), 16))  # (B*P, p, p, C)
    got = tp.patch_split(nchw(x), 16)
    np.testing.assert_array_equal(nhwc(got), want)
    np.testing.assert_array_equal(
        tp.patch_merge(got, 2, 32, 48).numpy(), nchw(x).numpy())


def test_patch_routing_function():
    rng = np.random.default_rng(1)
    x, f = _x(rng, 16), rng.standard_normal((2, 32)).astype(np.float32)
    tmod = tp.PatchRoutingFunction(16, 32, 4, 2, patch_size=16)
    (jg, ji, jv, _), (tg, ti, tv, _) = pair(
        jp.PatchRoutingFunction(16, 32, 4, 2, (1.0,) * 4, 16), tmod, rng, x,
        f, to_torch=_to_torch)
    assert tg.shape == (2 * 2 * 3, 4)
    assert kth_gap(tmod.logits(nchw(x), torch.from_numpy(f)), 2) > GAP_MIN
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), RTOL, ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), RTOL, ATOL)


def test_patch_adapter_layer():
    rng = np.random.default_rng(2)
    x, s = _x(rng, 16), _x(rng, 16)
    f = rng.standard_normal((2, 32)).astype(np.float32)
    tmod = tp.PatchAdapterLayer(16, 2, 4, 2, freq_dim=32)
    (want, _), got = pair(jp.PatchAdapterLayer(16, 2, 4, 2, freq_dim=32),
                          tmod, rng, x, f, s, to_torch=_to_torch)
    assert [e[0].body.patch_size for e in tmod.experts] == [4, 8, 16, 32]
    assert kth_gap(tmod.routing.logits(nchw(x), torch.from_numpy(f)),
                   2) > GAP_MIN
    np.testing.assert_allclose(nhwc(got), np.asarray(want), RTOL, ATOL)


def test_patch_decoder_block():
    rng = np.random.default_rng(3)
    kw = dict(rank=2, num_experts=4, top_k=2, freq_dim=32, patch_size=16)
    x = _x(rng, 16)
    f = rng.standard_normal((2, 32)).astype(np.float32)
    tmod = tp.PatchDecoderBlock(16, 2, **kw)
    (want, _), got = pair(jp.PatchDecoderBlock(16, 2, **kw), tmod, rng, x, f,
                          to_torch=_to_torch)
    assert isinstance(tmod.adapter, tp.PatchAdapterLayer)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), RTOL, ATOL)


TINY = dict(dim=16, num_blocks=(1, 1, 1))


@functools.lru_cache(maxsize=None)
def _jax_model(shape):
    x = np.random.default_rng(20).random(shape, dtype=np.float32)
    jnet = jp.MoCEIRPatch(**TINY)
    params = randomized(init_shapes(jnet, jnp.asarray(x))["params"],
                        np.random.default_rng(21))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, a: jnet.apply({"params": p}, a))(
            params, jnp.asarray(x)))
    return params, x, want


@pytest.mark.parametrize("shape", [(1, 40, 36, 3), (2, 32, 32, 3)])
def test_whole_model_matches_jax(shape):
    params, x, want = _jax_model(shape)
    tnet = load(get_model("moce_ir_patch", **TINY).eval(), params)
    gaps = routing_gaps(tnet)
    with torch.inference_mode():
        got = tnet(nchw(x))
    assert got.dtype == torch.float32 and got.shape == nchw(x).shape
    assert len(gaps) == 6 and min(gaps) > GAP_MIN
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_npz_checkpoint_loads(tmp_path):
    params, x, want = _jax_model((2, 32, 32, 3))
    path = str(tmp_path / "moce_patch.npz")
    save_params_npz(path, params)
    model = load_params({"model": "moce_ir_patch", "ckpt": path},
                        get_model("moce_ir_patch", **TINY)).eval()
    with torch.inference_mode():
        got = model(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_infer_cli_serves_moce_ir_patch(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    arr = (np.random.default_rng(30).random((37, 45, 3)) * 255).astype(
        np.uint8)
    Image.fromarray(arr).save(str(src / "im.png"))
    sets = ["--set", "model_kwargs.dim=16"]
    outs = infer.main(["--model", "moce_ir_patch", "--device", "cpu",
                       "--input", str(src), "--output_dir",
                       str(tmp_path / "out")] + sets)
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(37, 45, 3)]
