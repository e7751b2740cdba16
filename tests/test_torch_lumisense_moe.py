"""The port's LumiSenseMoE (``models/lumisense_moe.py``) against the JAX
package's, on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``),
the tree goes into the port through ``state_dict_from_jax``, and both run
the same seeded numpy inputs in fp32 (JAX at "highest" matmul precision,
torch with TF32 off); the port takes NCHW, the JAX package NHWC.

Tolerance: rtol=1e-4, atol=1e-5 for every module; the whole model at
atol=1e-5 x the largest |output| (random weights give outputs near 10) and
rtol=1e-4, with the routers' top-1/top-2 softmax gap above 1e-5 (fp32
rounding is ~1e-7), so no pick can flip between the packages.

* Modules: IGMSASimple (one and two heads), LumiEncoderBlock (the normed
  shortcut), LumiDecoderBlock (MoCE-IR's decoder block, switched at batch
  1 top-1, dense at batch 2).
* The whole model at dim 16, one block a level, 20x28 (padded to 16 inside,
  the residual to the padded image), batch 1 and batch 2, and
  ``lumisense_key_map``; a JAX ``.npz`` through ``load_params``;
  ``cli/infer.py --model lumisense_moe`` on the CPU.
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

from image_restoration_tpu.models import lumisense_moe as jl
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import lumisense_moe as tl


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _to_torch(x):
    return nchw(x) if np.ndim(x) == 4 else torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _x(rng, c, h=12, w=10, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("heads", [1, 2])
def test_igmsa_simple(heads):
    rng = np.random.default_rng(heads)
    want, got = pair(jl.IGMSASimple(16, heads, True),
                     tl.IGMSASimple(16, heads, True), rng, _x(rng, 16),
                     _x(rng, 16))
    _close(got, want)


def test_lumi_encoder_block():
    rng = np.random.default_rng(3)
    want, got = pair(jl.LumiEncoderBlock(16, 2), tl.LumiEncoderBlock(16, 2),
                     rng, _x(rng, 16), _x(rng, 16))
    _close(got, want)


@pytest.mark.parametrize("batch", [1, 2], ids=["switched", "dense"])
def test_lumi_decoder_block(batch):
    rng = np.random.default_rng(4 + batch)
    kw = dict(rank=2, num_experts=4, top_k=1, freq_dim=32)
    x = _x(rng, 16, b=batch)
    f = rng.standard_normal((batch, 32)).astype(np.float32)
    tmod = tl.LumiDecoderBlock(16, 2, **kw)
    (want, _), got = pair(jl.LumiDecoderBlock(16, 2, **kw), tmod, rng, x, f,
                          to_torch=_to_torch)
    gaps = routing_gaps(tmod)
    with torch.no_grad():
        tmod(nchw(x), torch.from_numpy(f))
    assert min(gaps) > GAP_MIN
    _close(got, want)


TINY = dict(dim=16, num_blocks=(1, 1, 1, 1))


@functools.lru_cache(maxsize=None)
def _jax_model(batch):
    x = np.random.default_rng(20 + batch).random((batch, 20, 28, 3),
                                                 dtype=np.float32)
    jnet = jl.LumiSenseMoEIR(**TINY)
    params = randomized(init_shapes(jnet, jnp.asarray(x))["params"],
                        np.random.default_rng(21))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, a: jnet.apply({"params": p}, a))(
            params, jnp.asarray(x)))
    return params, x, want


@pytest.mark.parametrize("batch", [1, 2])
def test_whole_model_matches_jax(batch):
    params, x, want = _jax_model(batch)
    tnet = load(get_model("lumisense_moe", **TINY).eval(), params,
                tl.lumisense_key_map)
    gaps = routing_gaps(tnet)
    with torch.inference_mode():
        got = tnet(nchw(x))
    assert got.dtype == torch.float32 and got.shape == nchw(x).shape
    assert len(gaps) == 3 and min(gaps) > GAP_MIN
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_key_map_and_npz(tmp_path):
    assert tl.lumisense_key_map("dec.2.2.layers.0.adapter.routing."
                                "complexity") is None
    assert (tl.lumisense_key_map("refinement.layers.0.ffn.dwconv.weight")
            == jl.lumisense_key_map("refinement.layers.0.ffn.dwconv.weight")
            == "refinement.0.ffn.dwconv.weight")
    params, x, want = _jax_model(1)
    path = str(tmp_path / "lumisense.npz")
    save_params_npz(path, params)
    model = load_params({"model": "lumisense_moe", "ckpt": path},
                        get_model("lumisense_moe", **TINY)).eval()
    with torch.inference_mode():
        got = model(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_infer_cli_serves_lumisense_moe(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    arr = (np.random.default_rng(30).random((37, 45, 3)) * 255).astype(
        np.uint8)
    Image.fromarray(arr).save(str(src / "im.png"))
    sets = ["--set", "model_kwargs.dim=16"]
    outs = infer.main(["--model", "lumisense_moe", "--device", "cpu",
                       "--input", str(src), "--output_dir",
                       str(tmp_path / "out")] + sets)
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(37, 45, 3)]
