"""The port's HierViG (``models/vig_h.py``) against the JAX package's, on
the same weights.

Seeded parameters (``tests/family_parity.py`` ``randomized``) go into the
port through ``state_dict_from_jax`` (``vig_h_key_map`` for the whole
model); both packages run the same seeded numpy inputs in fp32 (JAX
jitted at "highest" matmul precision, torch with TF32 off). Maps are
(B, H, W, C) inside both packages; images NHWC in JAX, NCHW in the port.

* GLA2D on a 12x10 map (120 tokens: two chunks), with and without the
  ``2dv1`` RoPE; VSSBlock with the GELU MLP and with the gated one
  (width rounded to 32); PatchMerging2D on an even and an odd map (the
  (0,0), (1,0), (0,1), (1,1) channel order; the odd side zero-padded).
  rtol=1e-4, atol=1e-5 x max|output|.
* The whole model (two or three narrow stages) in fp32, atol 1e-5 x
  max|logits|, rtol 1e-4: every downsample version (v1 PatchMerging2D, v2
  2x2, v3 3x3) and both patch embeds, gated and plain MLPs, ``2dv1``, and
  a 64x48 input whose first stage holds 192 tokens (three chunks). bf16
  (``dtype=bfloat16``): the port's bf16 logits against JAX's fp32 within
  2x the JAX bf16 model's max and mean error against them, plus 1e-3 x
  max; bf16 logits in both, as flax's LayerNorm keeps the stream fp32.
* The port's keys are the reference's: JAX's ``import_state_dict`` with
  the reference key map (tests/test_vig_h_parity.py ``_key_map``) fills
  the JAX tree from the port's ``state_dict`` bit for bit.
* One ``make_cls_train_step`` step (SGD, lr 0.1, momentum 0.9) against
  JAX's: the loss at rtol 1e-4, every gradient at atol 1e-5 x the
  largest.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from family_parity import ATOL, RTOL, init_shapes, load, randomized
from moe_parity import compiled

from image_restoration_tpu.models import vig_h as J
from image_restoration_tpu.train import classification as JC
from image_restoration_tpu.train import trainer as JT
from image_restoration_tpu.utils.torch_import import import_state_dict
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import vig_h as T
from image_restoration_tpu_torch.train import classification as TC
from image_restoration_tpu_torch.train import trainer as TT
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

SMALL = dict(patch_size=4, num_classes=10, depths=(1, 1), dims=(16, 32),
             num_heads=(2, 4), mlp_ratio=2.0)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _seeded(jmod, rng, *inputs):
    return randomized(init_shapes(jmod, *inputs)["params"], rng)


def _run(jmod, params, *inputs):
    return np.asarray(compiled(jmod.apply, {"params": params}, *inputs))


def _close(got, want):
    np.testing.assert_allclose(got, want, RTOL, ATOL * np.abs(want).max())


# name: (JAX module, port module, NHWC input shape)
MODULES = {
    "gla2d": (lambda: J.GLA2D(16, 2), lambda: T.GLA2D(16, 2),
              (2, 12, 10, 16)),
    "gla2d_2dv1": (lambda: J.GLA2D(16, 2, rope_mode="2dv1"),
                   lambda: T.GLA2D(16, 2, rope_mode="2dv1"),
                   (2, 12, 10, 16)),
    "vss_gelu": (lambda: J.VSSBlock(16, 2, mlp_ratio=2.0),
                 lambda: T.VSSBlock(16, 2, mlp_ratio=2.0), (2, 8, 6, 16)),
    "vss_gmlp": (lambda: J.VSSBlock(16, 2, gmlp=True),
                 lambda: T.VSSBlock(16, 2, gmlp=True), (2, 8, 6, 16)),
    "merge_even": (lambda: J.PatchMerging2D(8, 12),
                   lambda: T.PatchMerging2D(8, 12), (2, 6, 4, 8)),
    "merge_odd": (lambda: J.PatchMerging2D(8),
                  lambda: T.PatchMerging2D(8), (2, 5, 7, 8)),
}


def _sub_key_map(key):
    """vig_h_key_map for the keys of a submodule (no leading path)."""
    return T.vig_h_key_map("." + key)[1:]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module(name):
    jmk, tmk, shape = MODULES[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = jmk()
    params = _seeded(jmod, rng, x)
    tmod = load(tmk(), params, _sub_key_map).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    _close(got, _run(jmod, params, x))


# (fields beyond SMALL, NHWC input shape)
MODEL_CASES = {
    "v2_down": (dict(), (2, 32, 32, 3)),
    "v1_merge_gmlp": (dict(downsample_version="v1", gmlp=True),
                      (2, 32, 32, 3)),
    "v3_embed_v2_2dv1": (dict(downsample_version="v3",
                              patchembed_version="v2", rope_mode="2dv1",
                              depths=(1, 1, 1), dims=(16, 32, 32),
                              num_heads=(2, 4, 4)), (2, 36, 28, 3)),
    "three_chunks": (dict(), (1, 64, 48, 3)),
}


def _model_pair(case, seed=2, dtype=None):
    extra, shape = MODEL_CASES[case]
    kw = dict(SMALL, **extra)
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    jmod = J.HierViG(**kw)
    params = _seeded(jmod, rng, x)
    tmod = load(get_model("vig_h", **kw, dtype=dtype), params,
                T.vig_h_key_map)
    return jmod, params, tmod.eval(), x, kw


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_whole_model_fp32(case):
    jmod, params, tmod, x, _ = _model_pair(case)
    with torch.no_grad():
        got = tmod(_nchw(x)).numpy()
    _close(got, _run(jmod, params, x))
    back = import_state_dict(params, {k: v.numpy() for k, v in
                                      tmod.state_dict().items()},
                             key_map=T.vig_h_key_map)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_whole_model_bf16():
    jmod, params, tmod, x, kw = _model_pair("v1_merge_gmlp", 3,
                                            torch.bfloat16)
    want = _run(jmod, params, x)
    want16 = _run(J.HierViG(**kw, dtype=jax.numpy.bfloat16), params, x)
    with torch.no_grad():
        got = tmod(_nchw(x))
    assert got.dtype == torch.bfloat16 and want16.dtype == jax.numpy.bfloat16
    err_j = np.abs(want16.astype(np.float32) - want)
    err_t = np.abs(got.float().numpy() - want)
    slack = 1e-3 * np.abs(want).max()
    assert err_t.max() <= 2 * err_j.max() + slack, (err_t.max(), err_j.max())
    assert err_t.mean() <= 2 * err_j.mean() + slack, (err_t.mean(),
                                                      err_j.mean())


def test_cls_train_step_matches_jax():
    jmod, params, tmod, x, kw = _model_pair("v2_down", seed=4)
    labels = np.array([1, 8])
    jtx = optax.sgd(0.1, momentum=0.9)
    jstate = JT.TrainState.create(params, jtx)
    batch = {"image": jax.numpy.asarray(x), "label": jax.numpy.asarray(labels)}
    jstep = JC.make_cls_train_step(jmod, jtx, smoothing=0.1)
    jstate, jlogs = jstep.lower(jstate, batch).compile(
        {"xla_backend_optimization_level": 0})(jstate, batch)
    ttx = TT.Optimizer(TT.TrainerConfig(learning_rate=0.1, optimizer="sgd"))
    tstate = TT.TrainState.create(tmod, ttx)
    tstate, tlogs = TC.make_cls_train_step(tmod, ttx, smoothing=0.1)(
        tstate, {"image": _nchw(x), "label": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tlogs["loss"]), float(jlogs["loss"]),
                               rtol=RTOL)
    want = state_dict_from_jax(
        jax.tree.map(np.array, jstate.opt_state[0].trace),
        tmod.state_dict(), T.vig_h_key_map)
    scale = max(float(g.abs().max()) for g in want.values())
    for k, g in tstate.opt_state["trace"].items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=RTOL,
                                   atol=ATOL * scale, err_msg=k)
