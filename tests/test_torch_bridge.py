"""The weight bridge between the JAX package and the port.

``state_dict_from_jax`` -> the port's strict ``load_state_dict`` -> the
port's ``state_dict()`` -> the JAX ``import_state_dict`` must give back the
original JAX tree bit for bit; a tree of another architecture must raise.
The port's ``load_params`` reads both a JAX ``.npz`` export and a torch
checkpoint in a training envelope.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.models.restormer import Restormer as JRestormer
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu.utils.torch_import import import_state_dict
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

SMALL = dict(dim=16, num_blocks=(1, 2, 1, 1), num_refinement_blocks=1,
             heads=(1, 2, 4, 8))


def _jax_tree(seed=0, **over):
    """A seeded JAX Restormer param tree (shapes from eval_shape)."""
    cfg = dict(SMALL, **over)
    shapes = jax.eval_shape(JRestormer(**cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("ln_type,use_bias", [("WithBias", False),
                                              ("BiasFree", True)])
def test_roundtrip_is_bit_exact(ln_type, use_bias):
    tree = _jax_tree(ln_type=ln_type, use_bias=use_bias)
    port = get_model("restormer", **SMALL, ln_type=ln_type, use_bias=use_bias)
    port.load_state_dict(state_dict_from_jax(tree, port.state_dict()),
                         strict=True)
    assert "patch_embed.proj.weight" in port.state_dict()
    assert "encoder_level2.1.norm1.body.weight" in port.state_dict()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = import_state_dict(tree, sd)
    want, got = _leaves(tree), _leaves(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("over,err", [
    (dict(dim=8), ValueError),                 # every width differs
    (dict(num_blocks=(1, 1, 1, 1)), KeyError),  # a block short
    (dict(use_bias=True), KeyError),           # bias leaves with no home
])
def test_wrong_architecture_raises(over, err):
    port = get_model("restormer", **SMALL)
    with pytest.raises(err):
        state_dict_from_jax(_jax_tree(**over), port.state_dict())


def test_load_params_npz_and_torch_envelope(tmp_path):
    tree = _jax_tree(seed=1)
    npz = str(tmp_path / "params.npz")
    save_params_npz(npz, tree)
    port = load_params({"ckpt": npz}, get_model("restormer", **SMALL))
    want = port.state_dict()
    np.testing.assert_array_equal(
        want["encoder_level1.0.attn.qkv.weight"].numpy(),
        tree["encoder_level1_0"]["attn"]["qkv"]["conv"]["kernel"].transpose(3, 2, 0, 1))

    pth = str(tmp_path / "ckpt.pth")
    torch.save({"params": {f"module.{k}": v for k, v in want.items()}}, pth)
    other = load_params({"ckpt": pth}, get_model("restormer", **SMALL))
    for k, v in other.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError):
        load_params({"ckpt": str(tmp_path / "orbax_dir")},
                    get_model("restormer", **SMALL))
