"""The port's DRSformer against the JAX package's, same weights, and its
checkpoint bridge.

The JAX model's param tree is filled from a seed (LN affines, temperatures
and attn1..4 not at their init) and loaded into the port through
``state_dict_from_jax`` with ``drsformer_key_map`` and a strict
``load_state_dict``. The JAX side runs its plain modules (its fused path
runs them too off the TPU).

* Small config (dim 16, blocks 1/1/1/1, heads 1/2/4/8) at 32x32, the port's
  plain and fused paths, fp32: atol=1e-4.
* DRSformer-base at 32x32, fp32, fused: atol=5e-4, looser because the
  error of 40 blocks and two MEFC Subnets in series accumulates (fp32 sums
  in other orders at every op). Not at 16x16: there level 3 has 4x4
  pixels, so each head's 48x48 logits have rank 16 or less, and near-ties
  at a top-k threshold flip under fp32 reordering (a 4e-6 difference at
  level 3's input moved the output by 0.04 with seed 1). A flip changes
  which logits a row keeps, not the arithmetic, so it says nothing about
  the port.
* bf16, small config, fused: port bf16 vs JAX bf16 on the same input. Both
  round the same activations to bf16 (relative step 2^-8) but sum in other
  orders, and each framework's bf16 output is itself a few percent of the
  output's range from its fp32 output. Tolerance: max difference 5% and
  mean difference 1% of max|JAX output|, as for Restormer.
* Bridge: JAX tree -> port -> the port's state_dict -> the JAX importer
  with ``drsformer_key_map`` gives the original tree bit for bit; a tree of
  another architecture raises; ``load_params`` reads a JAX ``.npz``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.models.drsformer import DRSformer as JDRSformer
from image_restoration_tpu.models.drsformer import drsformer_key_map as jkey_map
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu.utils.torch_import import import_state_dict
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models.drsformer import drsformer_key_map
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax
from image_restoration_tpu_torch.utils.options import parse_options

SMALL = dict(dim=16, num_blocks=(1, 1, 1, 1), heads=(1, 2, 4, 8),
             ffn_expansion_factor=2.66)
BASE = dict(dim=48, num_blocks=(4, 6, 6, 8), heads=(1, 2, 4, 8),
            ffn_expansion_factor=2.66)
LEVELS = ("encoder_level1", "encoder_level2", "encoder_level3", "latent",
          "decoder_level3", "decoder_level2", "decoder_level1")


def _seeded_tree(jnet, hw, rng):
    """The JAX model's param tree (shapes from ``eval_shape``) filled from
    ``rng``: kernels at the fan-in scale, LN weights and temperatures
    around 1, attn1..4 around 0.25, biases around 0."""
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, hw, hw, 3)))["params"]

    def walk(tree, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
                continue
            z = rng.standard_normal(v.shape)
            if k == "kernel":
                z = z / np.sqrt(np.prod(v.shape[:-1]))
            elif k == "temperature" or (parent == "body" and k == "weight"):
                z = 1.0 + 0.2 * z
            elif k.startswith("attn"):
                z = 0.25 + 0.05 * z
            else:
                z = 0.2 * z
            out[k] = z.astype(np.float32)
        return out
    return walk(shapes)


@functools.lru_cache(maxsize=None)
def _jax_run(cfg_items, hw, dtype, seed):
    """(params, input, JAX output NHWC), made from ``seed``; cached so the
    port's plain and fused paths meet one JAX run."""
    rng = np.random.default_rng(seed)
    x = rng.random((1, hw, hw, 3), dtype=np.float32)
    jnet = JDRSformer(**dict(cfg_items),
                      dtype=None if dtype == "fp32" else jnp.bfloat16)
    params = _seeded_tree(jnet, hw, rng)

    @jax.jit
    def run(p, xx):
        with jax.default_matmul_precision("highest"):
            return jnet.apply({"params": p}, xx)

    return params, x, np.asarray(run(params, jnp.asarray(x)), np.float32)


def _pair(cfg, hw, fused, dtype, seed=0):
    """(JAX output, port output), both NHWC numpy, same weights and input."""
    params, x, want = _jax_run(tuple(cfg.items()), hw, dtype, seed)
    tnet = get_model("drsformer", **cfg, fused_block=fused,
                     dtype=None if dtype == "fp32" else torch.bfloat16).eval()
    tnet.load_state_dict(state_dict_from_jax(params, tnet.state_dict(),
                                             drsformer_key_map), strict=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        got = tnet(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert got.dtype == torch.float32
    return want, got.permute(0, 2, 3, 1).numpy(), tnet


@pytest.mark.parametrize("fused", [False, True])
def test_small_config_fp32(fused):
    want, got, _ = _pair(SMALL, 32, fused, "fp32")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_base_config_fp32():
    want, got, tnet = _pair(BASE, 32, True, "fp32", seed=1)
    assert sum(len(getattr(tnet, n)) for n in LEVELS) == 40
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_small_config_bf16():
    want, got, _ = _pair(SMALL, 32, True, "bf16", seed=2)
    assert np.isfinite(got).all()
    diff, scale = np.abs(got - want), np.abs(want).max()
    assert diff.max() < 0.05 * scale and diff.mean() < 0.01 * scale, (
        diff.max(), diff.mean(), scale)


def _jax_tree(seed=0, **over):
    cfg = dict(SMALL, **over)
    return _seeded_tree(JDRSformer(**cfg), 16, np.random.default_rng(seed))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("ln_type,use_bias", [("WithBias", False),
                                              ("BiasFree", True)])
def test_roundtrip_is_bit_exact(ln_type, use_bias):
    tree = _jax_tree(ln_type=ln_type, use_bias=use_bias)
    port = get_model("drsformer", **SMALL, ln_type=ln_type, use_bias=use_bias)
    port.load_state_dict(state_dict_from_jax(tree, port.state_dict(),
                                             drsformer_key_map), strict=True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    for key in ("encoder_level0.layers.0.ca_fc.0.weight",
                "encoder_level0.layers.1.preprocess.op.0.weight",
                "refinement.layers.1._ops.3._ops.3.op.4.weight",
                "refinement.layers.1._ops.0._ops.6.op.0.weight",
                "refinement.layers.1._ops.2._out.0.weight",
                "latent.0.attn.attn4", "decoder_level1.0.ffn.dwconv5x5_1.weight"):
        assert key in sd, key
    back = import_state_dict(tree, sd, key_map=jkey_map)
    want, got = _leaves(tree), _leaves(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("over,err", [
    (dict(dim=8), ValueError),                  # every width differs
    (dict(num_blocks=(1, 2, 1, 1)), KeyError),  # a block too many
    (dict(use_bias=True), KeyError),            # bias leaves with no home
])
def test_wrong_architecture_raises(over, err):
    port = get_model("drsformer", **SMALL)
    with pytest.raises(err):
        state_dict_from_jax(_jax_tree(**over), port.state_dict(),
                            drsformer_key_map)


def test_load_params_npz_and_serving_defaults(tmp_path):
    tree = _jax_tree(seed=1)
    npz = str(tmp_path / "params.npz")
    save_params_npz(npz, tree)
    port = load_params({"ckpt": npz, "model": "drsformer"},
                       get_model("drsformer", **SMALL))
    np.testing.assert_array_equal(
        port.state_dict()["encoder_level0.layers.1._ops.1._ops.5.op.0.weight"]
        .numpy(),
        tree["encoder_level0"]["_ops_1"]["_ops_5"]["op_0"]["kernel"]
        .transpose(3, 2, 0, 1))

    cfg = parse_options(["--model", "drsformer", "--device", "cpu"])
    assert cfg["bf16"] and cfg["model_kwargs"]["fused_block"]
    model = build_model(cfg)
    assert model.dtype == torch.bfloat16
    assert [len(getattr(model, n)) for n in LEVELS] == [4, 6, 6, 8, 6, 6, 4]
    assert model.patch_embed.proj.weight.shape == (48, 3, 3, 3)
    assert model.latent[0].attn.num_heads == 8
    assert model.decoder_level1[0].ffn.hidden == int(96 * 2.66)
    assert model.refinement.layers[1]._ops[0]._out[0].weight.shape == (96, 768, 1, 1)
