"""Two places where the port departed from the JAX package.

* ``ops/common.py`` ``pad_to_multiple`` against ``jnp.pad(mode="reflect")``
  (what the JAX ``pad_to_multiple`` calls) for every H and W from 1 to 16
  and the multiples 8 and 16: exact equality, also where the pad is not
  smaller than the side (``F.pad`` alone refuses those) and for a side of 1
  (the one pixel repeats). ``eval/tiled.py`` ``pad_test`` on a 3x6 and a
  4x6 image against the JAX ``pad_test`` with a function that mixes the
  padded border into the kept pixels.
* ``cli/robust.py`` classifies in fp32 unless ``--bf16`` is given, as the
  JAX CLI does; with the JAX CLI's own weights the default model's logits
  equal the JAX model's to atol 1e-4 (the fp32 logit tolerance of
  tests/test_torch_lsnet.py: fp32 sums in another order, JAX at "highest"
  matmul precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.cli import robust as jax_cli_robust
from image_restoration_tpu.eval import tiled as JT
from image_restoration_tpu_torch.cli import robust as cli_robust
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.eval import tiled as TT
from image_restoration_tpu_torch.models.lsnet import lsnet_key_map
from image_restoration_tpu_torch.ops.common import pad_to_multiple
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax
from image_restoration_tpu_torch.utils.options import parse_options

TINY_SET = ["--set", "model_kwargs.img_size=32",
            "--set", "model_kwargs.num_classes=5",
            "--set", "model_kwargs.embed_dim=(16,32,48,64)",
            "--set", "model_kwargs.key_dim=(8,8,8,8)",
            "--set", "model_kwargs.depth=(1,2,2,2)",
            "--set", "model_kwargs.num_heads=(2,2,2,2)"]


@pytest.mark.parametrize("multiple", [8, 16])
@pytest.mark.parametrize("h", range(1, 17))
def test_pad_to_multiple_equals_jnp_reflect(h, multiple):
    rng = np.random.default_rng(100 * multiple + h)
    for w in range(1, 17):
        a = rng.standard_normal((2, 3, h, w)).astype(np.float32)
        ph, pw = (-h) % multiple, (-w) % multiple
        want = np.asarray(jnp.pad(a, ((0, 0), (0, 0), (0, ph), (0, pw)),
                                  mode="reflect"))
        got, hw = pad_to_multiple(torch.from_numpy(a), multiple)
        assert hw == (h, w)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"w={w}")


@pytest.mark.parametrize("h,w", [(3, 6), (4, 6)])
def test_pad_test_on_images_smaller_than_the_pad(h, w):
    a = np.random.default_rng(h).standard_normal((1, h, w, 3)) \
        .astype(np.float32)
    want = JT.pad_test(lambda t: t + jnp.flip(t, (1, 2)), jnp.asarray(a), 8)
    got = TT.pad_test(lambda t: t + t.flip((-2, -1)),
                      torch.from_numpy(a).permute(0, 3, 1, 2), 8)
    assert got.shape == (1, 3, h, w)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def _compute_dtypes(model):
    return {m.compute_dtype for m in model.modules()
            if hasattr(m, "compute_dtype")}


@pytest.mark.parametrize("flag,dtype", [((), torch.float32),
                                        (("--bf16",), torch.bfloat16),
                                        (("--fp32",), torch.float32)])
def test_robust_cli_dtype(flag, dtype):
    cfg = parse_options(TINY_SET + ["--device", "cpu", *flag],
                        cli_robust.build_argparser())
    assert cfg["bf16"] == (dtype == torch.bfloat16) and cfg["model"] == "lsnet"
    model = build_model(cfg)
    # fp32 is "no compute dtype": every op promotes to the fp32 parameters'
    want = {None} if dtype == torch.float32 else {dtype}
    assert _compute_dtypes(model) == want
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_robust_cli_default_logits_equal_the_jax_cli_models():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = jax_cli_robust.build_argparser().parse_args(
        ["--model", "lsnet", "--input_size", "32"] + TINY_SET)
    apply_fn, variables = jax_cli_robust._load_model_and_params(args)[:2]
    rng = np.random.default_rng(7)
    variables = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), variables)
    model = build_model(parse_options(TINY_SET + ["--device", "cpu"],
                                      cli_robust.build_argparser())).eval()
    model.load_state_dict(state_dict_from_jax(
        variables["params"], model.state_dict(), lsnet_key_map,
        variables["batch_stats"]), strict=True)
    imgs = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(apply_fn(variables, jnp.asarray(imgs)))
    with torch.no_grad():
        got = model(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
