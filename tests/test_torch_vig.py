"""The port's ViG (``models/vig.py``) against the JAX package's, on the same
weights, and its classification surfaces.

Each JAX module gets seeded random parameters (``tests/family_parity.py``
``randomized``: kernels at the fan-in scale, norm weights near 1, biases,
cls token, position embedding and layer scales at 0.5 N(0, 1)), the tree
goes into the port through ``state_dict_from_jax`` (``vig_key_map`` for
the whole model), and both run the same seeded numpy inputs in fp32 (JAX
jitted at "highest" matmul precision, torch with TF32 off). Tokens are
(B, L, C) in both packages; images NHWC in JAX, NCHW in the port.

* Every module: RMSNorm; ``rope_2dv0`` and ``rope_2dv1``; the GLA on a
  12x10 grid (120 patches: two chunks) with the cls token at the middle
  and without it, under each ``rope_mode`` (``2dv1`` with the cls token
  takes the reference's splice of the un-rotated patch projection), and
  with ``clamp_min``, a dwconv bias and no conv activation; GLAMLP (width
  rounded to 256), GLAMlpPlain; GLABlock plain and with SwiGLU and layer
  scales. rtol=1e-4, atol=1e-5.
* The whole model in fp32 (atol 1e-5 x max|logits|, rtol 1e-4): the
  ``mid_clstok`` v1 model at patch 4 on 48x40 (121 tokens: two chunks)
  with its position embedding resized up from 8x8 and down from 16x16
  (the antialiased bicubic); ``avgpool`` with the v2 patch embed, ``2dv0``,
  SwiGLU and layer scales; ``mid_clstok`` with v2 and ``2dv1``; ``feat``
  (the final map, NCHW in the port). bf16 (``dtype=bfloat16``): the
  port's bf16 logits against JAX's fp32 ones within 2x the JAX bf16
  model's max and mean error against them, plus 1e-3 x max (the two
  round in different places); the dtypes JAX gives (bf16 logits, an fp32
  stream after v2's LayerNorm).
* The port's keys are the reference's: JAX's ``import_state_dict`` with
  the reference key map (tests/test_vig_parity.py ``_vig_key_map``) fills
  the JAX tree from the port's ``state_dict`` bit for bit; ``load_params``
  reads a JAX ``.npz``.
* One ``make_cls_train_step`` step (SGD, lr 0.1, momentum 0.9: the trace
  after one step is the gradient) against JAX's on the same batch: the
  loss at rtol 1e-4, every gradient at atol 1e-5 x the largest.
* ``cli/robust.py --model vig --device cpu`` against the JAX
  ``cli/robust.py`` on a PIL-written ImageFolder, both loading one JAX
  ``.npz``: the same accuracies.
"""

import functools
import os

import flax.linen as nn
import jax
import numpy as np
import optax
import pytest
import torch
from family_parity import ATOL, RTOL, init_shapes, load, randomized
from moe_parity import compiled

from image_restoration_tpu.cli import robust as jax_robust
from image_restoration_tpu.models import vig as J
from image_restoration_tpu.train import classification as JC
from image_restoration_tpu.train import trainer as JT
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu.utils.torch_import import import_state_dict
from image_restoration_tpu_torch.cli import robust as port_robust
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import vig as T
from image_restoration_tpu_torch.train import classification as TC
from image_restoration_tpu_torch.train import trainer as TT
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

Image = pytest.importorskip("PIL.Image")

SMALL = dict(img_size=32, patch_size=4, depth=2, num_heads=2, embed_dim=32,
             num_classes=10)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _seeded(jmod, rng, *inputs, **static):
    return randomized(init_shapes(jmod, *inputs, **static)["params"], rng)


def _run(jmod, params, *inputs, **static):
    return np.asarray(compiled(functools.partial(jmod.apply, **static),
                               {"params": params}, *inputs))


def _tokens(rng, l, c=32, b=2):
    return rng.standard_normal((b, l, c)).astype(np.float32)


def test_rmsnorm_and_ropes():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    params = _seeded(J.RMSNorm(), rng, x)
    tmod = load(T.RMSNorm(8), params).eval()
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(),
                               _run(J.RMSNorm(), params, x), RTOL, ATOL)
    t = rng.standard_normal((2, 2, 12 * 10, 8)).astype(np.float32)
    np.testing.assert_allclose(
        T.rope_2dv0(torch.from_numpy(t), 12, 10, 8).numpy(),
        np.asarray(J.rope_2dv0(t, 12, 10, 8)), RTOL, ATOL)
    t = t.transpose(0, 2, 1, 3).copy()  # token-major (B, N, heads, D)
    np.testing.assert_allclose(
        T.rope_2dv1(torch.from_numpy(t), 12, 10, 8).numpy(),
        np.asarray(J.rope_2dv1(t, 12, 10, 8)), RTOL, ATOL)


# (rope_mode, cls token at the middle, extra GatedLinearAttention fields)
GLA_CASES = [("none", True, {}), ("none", False, {}), ("2dv0", False, {}),
             ("2dv1", True, {}), ("2dv1", False, {}),
             ("none", True, dict(clamp_min=-0.05, use_bias_in_dwconv=True,
                                 use_act_in_conv=False))]


@pytest.mark.parametrize("rope,cls,extra", GLA_CASES,
                         ids=[f"{r}-{'cls' if c else 'nocls'}-{len(e)}"
                              for r, c, e in GLA_CASES])
def test_gated_linear_attention(rope, cls, extra):
    rng = np.random.default_rng(1)
    h, w = 12, 10
    tp = h * w // 2 if cls else None
    x = _tokens(rng, h * w + int(cls))
    jmod = J.GatedLinearAttention(32, num_heads=2, rope_mode=rope, **extra)
    static = dict(patch_resolution=(h, w), token_position=tp)
    params = _seeded(jmod, rng, x, **static)
    tmod = load(T.GatedLinearAttention(32, num_heads=2, rope_mode=rope,
                                       **extra), params).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), (h, w), tp).numpy()
    want = _run(jmod, params, x, **static)
    np.testing.assert_allclose(got, want, RTOL, ATOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["GLAMLP", "GLAMlpPlain", "GLABlock",
                                  "GLABlock_swiglu_scale"])
def test_mlps_and_block(name):
    rng = np.random.default_rng(2)
    x = _tokens(rng, 8 * 6 + 1)
    static = {}
    if name.startswith("GLABlock"):
        kw = (dict(use_swiglu=True, init_values=0.3, rope_mode="2dv1")
              if name.endswith("scale") else {})
        jmod, tmod = J.GLABlock(32, 2, **kw), T.GLABlock(32, 2, **kw)
        static = dict(patch_resolution=(8, 6), token_position=24)
    else:
        jmod, tmod = getattr(J, name)(32), getattr(T, name)(32)
    params = _seeded(jmod, rng, x, **static)
    load(tmod, params).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), *static.values()).numpy()
    want = _run(jmod, params, x, **static)
    np.testing.assert_allclose(got, want, RTOL, ATOL * np.abs(want).max())


# (model fields beyond SMALL, NHWC input shape)
MODEL_CASES = {
    "clstok_v1_up": (dict(), (2, 48, 40, 3)),
    "clstok_v1_down": (dict(img_size=64), (2, 48, 40, 3)),
    "avgpool_v2_2dv0_swiglu": (dict(classification_mode="avgpool",
                                    patch_embed_version="v2",
                                    rope_mode="2dv0", use_swiglu=True,
                                    init_values=0.3), (2, 32, 32, 3)),
    "clstok_v2_2dv1": (dict(patch_embed_version="v2", rope_mode="2dv1"),
                       (2, 32, 32, 3)),
    "feat": (dict(classification_mode="feat"), (1, 32, 24, 3)),
}


def _model_pair(case, seed=3, dtype=None):
    extra, shape = MODEL_CASES[case]
    kw = dict(SMALL, **extra)
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    jmod = J.ViG(**kw)
    params = _seeded(jmod, rng, x)
    tmod = load(get_model("vig", **kw, dtype=dtype), params, T.vig_key_map)
    return jmod, params, tmod.eval(), x, kw


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_whole_model_fp32(case):
    jmod, params, tmod, x, kw = _model_pair(case)
    want = _run(jmod, params, x)
    with torch.no_grad():
        got = tmod(_nchw(x)).numpy()
    if case == "feat":
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, RTOL, ATOL * np.abs(want).max())
    # the port's keys are the reference's: the JAX importer with the
    # reference key map puts every port tensor back where it came from
    back = import_state_dict(params, {k: v.numpy() for k, v in
                                      tmod.state_dict().items()},
                             key_map=T.vig_key_map)
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize("case", ["clstok_v1_up", "avgpool_v2_2dv0_swiglu"])
def test_whole_model_bf16(case):
    jmod, params, tmod, x, kw = _model_pair(case, 4, torch.bfloat16)
    want = _run(jmod, params, x)
    want16 = _run(J.ViG(**kw, dtype=jax.numpy.bfloat16), params, x)
    with torch.no_grad():
        got = tmod(_nchw(x))
    assert got.dtype == torch.bfloat16 and want16.dtype == jax.numpy.bfloat16
    err_j = np.abs(want16.astype(np.float32) - want)
    err_t = np.abs(got.float().numpy() - want)
    slack = 1e-3 * np.abs(want).max()
    assert err_t.max() <= 2 * err_j.max() + slack, (err_t.max(), err_j.max())
    assert err_t.mean() <= 2 * err_j.mean() + slack, (err_t.mean(),
                                                      err_j.mean())


def test_load_params_npz(tmp_path):
    jmod, params, _, x, kw = _model_pair("clstok_v1_up")
    npz = str(tmp_path / "vig.npz")
    save_params_npz(npz, params)
    tmod = load_params({"ckpt": npz, "model": "vig"}, get_model("vig", **kw))
    with torch.no_grad():
        got = tmod.eval()(_nchw(x)).numpy()
    want = _run(jmod, params, x)
    np.testing.assert_allclose(got, want, RTOL, ATOL * np.abs(want).max())


def test_cls_train_step_matches_jax():
    jmod, params, tmod, x, kw = _model_pair("clstok_v1_up", seed=5)
    labels = np.array([3, 7])
    jtx = optax.sgd(0.1, momentum=0.9)
    jstate = JT.TrainState.create(params, jtx)
    jstep = JC.make_cls_train_step(jmod, jtx, smoothing=0.1)
    batch = {"image": jax.numpy.asarray(x), "label": jax.numpy.asarray(labels)}
    jstate, jlogs = jstep.lower(jstate, batch).compile(
        {"xla_backend_optimization_level": 0})(jstate, batch)
    ttx = TT.Optimizer(TT.TrainerConfig(learning_rate=0.1, optimizer="sgd"))
    tstate = TT.TrainState.create(tmod, ttx)
    tstate, tlogs = TC.make_cls_train_step(tmod, ttx, smoothing=0.1)(
        tstate, {"image": _nchw(x), "label": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tlogs["loss"]), float(jlogs["loss"]),
                               rtol=RTOL)
    trace = jax.tree.map(np.array, jstate.opt_state[0].trace)
    want = state_dict_from_jax(trace, tmod.state_dict(), T.vig_key_map)
    scale = max(float(g.abs().max()) for g in want.values())
    for k, g in tstate.opt_state["trace"].items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=RTOL,
                                   atol=ATOL * scale, err_msg=k)


def _write_tree(root, rng, classes=("n01", "n02", "n03"), n=2):
    for c in classes:
        os.makedirs(os.path.join(root, c), exist_ok=True)
        for i in range(n):
            h, w = rng.integers(24, 48, 2)
            arr = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(root, c, f"{i}.png"))


def test_cli_robust_matches_jax(tmp_path, monkeypatch):
    # the JAX CLI inits its model op by op (~100 compiles, 12 s); jitted,
    # the init gives the same variables, which the .npz then replaces
    init = nn.Module.init
    monkeypatch.setattr(J.ViG, "init", lambda self, *a: jax.jit(
        functools.partial(init, self))(*a))
    kw = dict(SMALL, depth=1, embed_dim=16, num_classes=5)
    rng = np.random.default_rng(6)
    x = np.zeros((1, 32, 32, 3), np.float32)
    params = _seeded(J.ViG(**kw), rng, x)
    npz = str(tmp_path / "vig.npz")
    save_params_npz(npz, params)
    _write_tree(str(tmp_path / "sk"), rng)
    argv = ["--model", "vig", "--ckpt", npz, "--insk_path",
            str(tmp_path / "sk"), "--batch_size", "6", "--input_size", "32"]
    for k in ("img_size", "patch_size", "depth", "num_heads", "embed_dim",
              "num_classes"):
        argv += ["--set", f"model_kwargs.{k}={kw[k]}"]
    want = jax_robust.main(argv)
    got = port_robust.main(argv + ["--device", "cpu"])
    assert got == want and got["imagenet_sketch"]["n"] == 6
