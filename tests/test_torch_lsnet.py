"""The port's LSNet against the JAX package's, same variables, and its
checkpoint bridge.

Each JAX module's variables (params and BatchNorm ``batch_stats``) are
filled from a numpy seed: kernels at the fan-in scale, BN/GroupNorm
weights around 1, biases, running means and LeViT ``attention_biases``
away from 0, running variances in [0.5, 1.5], so that no BN is the
identity. They reach the port through ``state_dict_from_jax`` with
``lsnet_key_map`` and a strict ``load_state_dict``. The JAX side runs the
plain ``ska_xla``; the port runs its kernel's wrapper, which on a CPU
tensor is ``ska_plain`` (tests/test_torch_ska.py holds the two together).

* Every module (ConvBN, SqueezeExcite, RepVGGDW, FFN, LKP with its
  GroupNorm, LSConv at wc 2 and 6, LeViTAttention at its resolution and
  below it, LSBlock of each kind, the head's BatchNorm1d), fp32 with TF32
  off and JAX at "highest" precision: rtol=1e-4, atol=1e-5 (fp32 sums in
  other orders).
* BatchNorm2d in train mode: the batch-stat output and the unbiased
  running update, fp32, rtol=1e-5, atol=1e-6.
* The whole LSNet at the small config of tests/test_lsnet_parity.py (img
  64, embed 16/32/48/64, key_dim 8, depth 1/2/2/2, heads 2, 10 classes):
  fp32 logits atol=1e-4; ``features=True`` stage maps atol=1e-4. bf16:
  both packages round the same activations to bf16 (relative step 2^-8)
  but sum in other orders, and through 7 blocks each bf16 output drifts a
  few percent of the range from the fp32 one in its own way (seed 2, the
  last stage map: JAX 3.8% at most, the port 3.0%), so
  the two bf16 outputs are not held to each other: the port's bf16 logits
  must stay within 2x the JAX bf16 logits' max and mean error against the
  JAX fp32 logits.
* Bridge: port -> JAX ``import_variables`` with the JAX
  ``lsnet_key_map`` (the importer the JAX package checks against the
  reference torch LSNet) gives the original variables bit for bit, so the
  port's keys are the reference's; a params-only tree leaves the running
  statistics at init; another architecture raises; ``load_params`` reads a
  JAX ``.npz``; ``MODEL_DEFAULTS["lsnet"]`` builds LSNet-T on the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.models import lsnet as JL
from image_restoration_tpu.ops.layernorm import BatchNorm2d as JBatchNorm2d
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu.utils.torch_import import import_variables
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.models import KEY_MAPS, get_model
from image_restoration_tpu_torch.models import lsnet as TL
from image_restoration_tpu_torch.ops.layernorm import BatchNorm2d
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax
from image_restoration_tpu_torch.utils.options import parse_options

SMALL = dict(img_size=64, patch_size=8, num_classes=10,
             embed_dim=(16, 32, 48, 64), key_dim=(8, 8, 8, 8),
             depth=(1, 2, 2, 2), num_heads=(2, 2, 2, 2))


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _seeded_variables(jmod, x, rng):
    """The JAX module's variables (shapes from ``eval_shape``) from ``rng``."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            z = rng.standard_normal(v.shape)
            if k == "kernel":
                z = z / np.sqrt(np.prod(v.shape[:-1]))
            elif k in ("weight", "scale"):
                z = 1.0 + 0.2 * z
            elif k == "running_var":
                z = 0.5 + rng.random(v.shape)
            elif k == "attention_biases":
                z = 0.5 * z
            else:  # bias, running_mean
                z = 0.2 * z
            out[k] = z.astype(np.float32)
        return out

    return {c: walk(t) for c, t in shapes.items()}


def _sub_key_map(key):
    """lsnet_key_map for the keys of a submodule (no leading path)."""
    mapped = TL.lsnet_key_map("." + key)
    return None if mapped is None else mapped[1:]


def _load(tmod, variables, key_map=_sub_key_map):
    tmod.load_state_dict(state_dict_from_jax(
        variables["params"], tmod.state_dict(), key_map,
        variables.get("batch_stats")), strict=True)
    return tmod.eval()


def _run_jax(jmod, variables, x):
    with jax.default_matmul_precision("highest"):
        return jax.jit(jmod.apply)(variables, jnp.asarray(x))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# name: (JAX module, port module, NHWC input shape)
MODULES = {
    "ConvBN": (lambda: JL.ConvBN(12, 3, 2, 1, 4),
               lambda: TL.ConvBN(8, 12, 3, 2, 1, 4), (2, 9, 7, 8)),
    "SqueezeExcite": (lambda: JL.SqueezeExcite(16),
                      lambda: TL.SqueezeExcite(16), (2, 9, 7, 16)),
    "RepVGGDW": (lambda: JL.RepVGGDW(16), lambda: TL.RepVGGDW(16),
                 (2, 9, 7, 16)),
    "FFN": (lambda: JL.FFN(16, 32), lambda: TL.FFN(16, 32), (2, 9, 7, 16)),
    "LKP": (lambda: JL.LKP(16), lambda: TL.LKP(16), (2, 9, 7, 16)),
    "LSConv_wc2": (lambda: JL.LSConv(16), lambda: TL.LSConv(16, True),
                   (2, 9, 7, 16)),
    "LSConv_wc6": (lambda: JL.LSConv(48), lambda: TL.LSConv(48, True),
                   (1, 7, 9, 48)),
    "LeViTAttention": (lambda: JL.LeViTAttention(32, 8, 2, 2.0, 4),
                       lambda: TL.LeViTAttention(32, 8, 2, 2.0, 4),
                       (2, 4, 4, 32)),
    "LeViTAttention_n_below_res2": (
        lambda: JL.LeViTAttention(32, 8, 2, 2.0, 4),
        lambda: TL.LeViTAttention(32, 8, 2, 2.0, 4), (2, 3, 3, 32)),
    "LSBlock_repvgg_se": (lambda: JL.LSBlock(16, 8, 2, 1.0, 8, 0, 0),
                          lambda: TL.LSBlock(16, 8, 2, 1.0, 8, 0, 0),
                          (2, 8, 8, 16)),
    "LSBlock_lsconv": (lambda: JL.LSBlock(32, 8, 2, 2.0, 4, 1, 1),
                       lambda: TL.LSBlock(32, 8, 2, 2.0, 4, 1, 1, True),
                       (2, 5, 6, 32)),
    "LSBlock_attention": (lambda: JL.LSBlock(32, 8, 2, 2.0, 4, 3, 1),
                          lambda: TL.LSBlock(32, 8, 2, 2.0, 4, 3, 1),
                          (2, 4, 4, 32)),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name):
    jctor, tctor, shape = MODULES[name]
    rng = np.random.default_rng(sorted(MODULES).index(name))
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = jctor()
    variables = _seeded_variables(jmod, jnp.asarray(x), rng)
    want = np.asarray(_run_jax(jmod, variables, x))
    tmod = _load(tctor(), variables)
    with torch.inference_mode():
        got = tmod(_nchw(x))
    got = got.numpy() if name == "LKP" else _nhwc(got)  # LKP: (B,H,W,wc,9)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_head_batchnorm1d_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 24)).astype(np.float32)
    variables = _seeded_variables(JL.BatchNorm1d(), jnp.asarray(x), rng)
    want = np.asarray(_run_jax(JL.BatchNorm1d(), variables, x))
    tmod = _load(TL.BatchNorm1d(24), variables)
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=1e-5, atol=1e-6)


def test_batchnorm2d_train_mode_matches_jax():
    rng = np.random.default_rng(8)
    x = (1.5 * rng.standard_normal((3, 5, 4, 6)) + 0.3).astype(np.float32)
    jbn = JBatchNorm2d()
    variables = _seeded_variables(jbn, jnp.asarray(x), rng)
    want, upd = jbn.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    bn = _load(BatchNorm2d(6), variables).train()
    got = bn(_nchw(x))
    np.testing.assert_allclose(_nhwc(got.detach()), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


def _lsnet_pair(dtype, features=False, seed=0):
    """(JAX output, port output, JAX variables) of the small LSNet."""
    rng = np.random.default_rng(seed)
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    jdt = None if dtype == "fp32" else jnp.bfloat16
    tdt = None if dtype == "fp32" else torch.bfloat16
    jnet = JL.LSNet(**SMALL, features=features, dtype=jdt)
    variables = _seeded_variables(jnet, jnp.asarray(x), rng)
    want = _run_jax(jnet, variables, x)
    tnet = _load(get_model("lsnet", **SMALL, use_pallas_ska=True,
                           features=features, dtype=tdt), variables,
                 TL.lsnet_key_map)
    with torch.inference_mode():
        got = tnet(_nchw(x))
    return want, got, variables


def test_lsnet_fp32_logits():
    want, got, _ = _lsnet_pair("fp32")
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_lsnet_features():
    want, got, _ = _lsnet_pair("fp32", features=True, seed=1)
    assert len(got) == 4
    for w, g, c in zip(want, got, SMALL["embed_dim"]):
        assert g.shape[1] == c
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_lsnet_bf16_logits():
    want32, _, _ = _lsnet_pair("fp32", seed=2)
    want, got, _ = _lsnet_pair("bf16", seed=2)
    want32, want = np.asarray(want32), np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err_port = np.abs(got.numpy() - want32)
    err_jax = np.abs(want - want32)
    assert err_port.max() <= 2 * err_jax.max(), (err_port.max(), err_jax.max())
    assert err_port.mean() <= 2 * err_jax.mean(), (err_port.mean(),
                                                   err_jax.mean())


def test_bridge_roundtrip_through_the_jax_importer_is_bit_exact():
    _, _, variables = _lsnet_pair("fp32", seed=3)
    tnet = _load(get_model("lsnet", **SMALL), variables, TL.lsnet_key_map)
    sd = {k: v.numpy() for k, v in tnet.state_dict().items()}
    for key in ("blocks2.3.mixer.lkp.norm.weight",
                "blocks4.3.mixer.m.proj.1.c.weight",
                "blocks4.3.mixer.m.attention_bias_idxs",
                "blocks1.0.ffn.m.pw2.bn.running_var",
                "blocks2.0.c.weight", "head.bn.running_mean", "head.l.weight"):
        assert key in sd, key
    back = import_variables(variables, sd, key_map=JL.lsnet_key_map)
    for coll in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[coll])
        got = dict(jax.tree_util.tree_leaves_with_path(back[coll]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                          err_msg=str(path))


def test_params_only_keeps_init_statistics_and_buffers():
    _, _, variables = _lsnet_pair("fp32", seed=4)
    tnet = get_model("lsnet", **SMALL)
    init = {k: v.clone() for k, v in tnet.state_dict().items()}
    sd = state_dict_from_jax(variables["params"], tnet.state_dict(),
                             TL.lsnet_key_map)
    for k, v in sd.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked",
                       "attention_bias_idxs")):
            assert torch.equal(v, init[k]), k
    assert not torch.equal(sd["head.l.weight"], init["head.l.weight"])


@pytest.mark.parametrize("over,err", [
    (dict(embed_dim=(16, 32, 48, 72)), ValueError),   # a width differs
    (dict(depth=(1, 2, 3, 2)), KeyError),             # a block too many
])
def test_wrong_architecture_raises(over, err):
    _, _, variables = _lsnet_pair("fp32", seed=5)
    port = get_model("lsnet", **dict(SMALL, **over))
    with pytest.raises(err):
        state_dict_from_jax(variables["params"], port.state_dict(),
                            TL.lsnet_key_map, variables["batch_stats"])


def test_load_params_npz_and_serving_defaults(tmp_path):
    _, _, variables = _lsnet_pair("fp32", seed=6)
    npz = str(tmp_path / "params.npz")
    save_params_npz(npz, variables["params"])
    cfg = {"ckpt": npz, "model": "lsnet"}
    port = load_params(cfg, get_model("lsnet", **SMALL))
    assert KEY_MAPS["lsnet"] is TL.lsnet_key_map
    np.testing.assert_array_equal(
        port.state_dict()["blocks2.3.mixer.lkp.cv2.c.weight"].numpy(),
        variables["params"]["blocks2_3"]["mixer"]["lkp"]["cv2"]["c"]["kernel"]
        .transpose(3, 2, 0, 1))

    model = build_model(parse_options(["--model", "lsnet", "--device", "cpu"]))
    assert model.dtype == torch.bfloat16 and not model.training
    assert [len(getattr(model, f"blocks{i}")) for i in (1, 2, 3, 4)] == [
        1, 4, 5, 6]  # depth 1/2/3/4, stages 2-4 led by a downsample pair
    assert all(m.use_pallas_ska for m in model.modules()
               if isinstance(m, TL.LSConv))
