"""The port's Restormer against the JAX package's, same weights.

The JAX model's param tree is filled from a seed (LN affines and
temperatures not the identity) and loaded into the port through
``state_dict_from_jax`` with a strict ``load_state_dict``.

* Small config (dim 16, blocks 1/1/1/1, 1 refinement, heads 1/2/4/8) at
  32x32, plain and fused blocks, fp32: atol=1e-4.
* Restormer-base at 16x16, fp32: atol=5e-4, looser because the error of 44
  blocks in series accumulates (fp32 sums in other orders at every op).
* bf16, small config, plain and fused blocks: port bf16 vs JAX bf16 on the
  same input. Both round the same activations to bf16 (relative step 2^-8)
  but sum in other orders, so single activations differ by a bf16 step and
  that drift propagates through the U-Net; each framework's bf16 output is
  itself ~2% (of the output's range) from its fp32 output. Tolerance: max
  difference 5% and mean difference 1% of max|JAX output|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.models.restormer import Restormer as JRestormer
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

SMALL = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
             heads=(1, 2, 4, 8), ffn_expansion_factor=2.66)
BASE = dict(dim=48, num_blocks=(4, 6, 6, 8), num_refinement_blocks=4,
            heads=(1, 2, 4, 8), ffn_expansion_factor=2.66)


def _seeded_params(jnet, x, rng):
    """The JAX model's param tree (shapes from ``eval_shape``, which skips
    the slow eager init) filled from ``rng``: conv kernels at the lecun
    scale, LN affines and temperatures around 1 and 0."""
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x)["params"]

    def walk(tree, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
                continue
            z = rng.standard_normal(v.shape).astype(np.float32)
            if k == "kernel":
                out[k] = z / np.sqrt(np.prod(v.shape[:-1]))
            elif k == "temperature" or (parent == "body" and k == "weight"):
                out[k] = 1.0 + 0.2 * z
            else:  # LN and conv biases
                out[k] = 0.2 * z
        return out
    return walk(shapes)


def _pair(cfg, hw, fused, dtype, seed=0):
    """(JAX apply fn, port model, input NHWC) with shared weights."""
    rng = np.random.default_rng(seed)
    x = rng.random((1, hw, hw, 3), dtype=np.float32)
    jdt = None if dtype == "fp32" else jnp.bfloat16
    tdt = None if dtype == "fp32" else torch.bfloat16
    jnet = JRestormer(**cfg, fused_block=fused, dtype=jdt)
    params = _seeded_params(jnet, jnp.asarray(x), rng)
    tnet = get_model("restormer", **cfg, fused_block=fused, dtype=tdt).eval()
    tnet.load_state_dict(state_dict_from_jax(params, tnet.state_dict()),
                         strict=True)

    @jax.jit
    def japply(p, xx):
        with jax.default_matmul_precision("highest"):
            return jnet.apply({"params": p}, xx)

    def jrun(xx):
        return np.asarray(japply(params, jnp.asarray(xx)))

    return jrun, tnet, x


def _run_port(tnet, x):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        out = tnet(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert out.dtype == torch.float32
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("fused", [False, True])
def test_small_config_fp32(fused):
    jrun, tnet, x = _pair(SMALL, 32, fused, "fp32")
    np.testing.assert_allclose(_run_port(tnet, x), jrun(x), rtol=0, atol=1e-4)


def test_base_config_fp32():
    jrun, tnet, x = _pair(BASE, 16, True, "fp32", seed=1)
    assert sum(len(getattr(tnet, n)) for n in (
        "encoder_level1", "encoder_level2", "encoder_level3", "latent",
        "decoder_level3", "decoder_level2", "decoder_level1",
        "refinement")) == 44
    np.testing.assert_allclose(_run_port(tnet, x), jrun(x), rtol=0, atol=5e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_small_config_bf16(fused):
    jrun, tnet, x = _pair(SMALL, 32, fused, "bf16", seed=2)
    got, want = _run_port(tnet, x), jrun(x).astype(np.float32)
    assert np.isfinite(got).all()
    diff, scale = np.abs(got - want), np.abs(want).max()
    assert diff.max() < 0.05 * scale and diff.mean() < 0.01 * scale, (
        diff.max(), diff.mean(), scale)
