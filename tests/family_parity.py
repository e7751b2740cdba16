"""Shared helpers of the port's parity tests for CG-IR, NeRD-Rain, MEASNet
and the MoCE family (tests/test_torch_cg_ir.py, test_torch_nerd_rain.py,
test_torch_measnet.py, test_torch_moce_ir.py, test_torch_igmoce_ir.py,
test_torch_lumisense_moe.py, test_torch_moce_ir_patch.py): seeded
parameter trees, the JAX -> port weight load, a module pair run on the
same numpy inputs in fp32 (JAX at "highest" matmul precision, torch with
TF32 off), and the MoE routers' pick margins."""

import functools

import jax
import numpy as np
import torch

from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

RTOL, ATOL = 1e-4, 1e-5
# Least gap between the k-th and (k+1)-th softmax score of a MoE router for
# its pick to be the same in both packages: fp32 rounding is ~1e-7.
GAP_MIN = 1e-5


def randomized(shapes, rng, scale=0.5):
    """Every leaf of a param tree (or its shapes) replaced by seeded values:
    kernels at the fan-in scale, LN and norm weights and temperatures near
    1, the rest (biases, log temperatures, dictionaries) near 0 at
    ``scale``."""
    def walk(tree, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
                continue
            z = rng.standard_normal(v.shape)
            if k == "kernel":
                z = z / np.sqrt(np.prod(v.shape[:-1]))
            elif k in ("temperature", "scale", "param_beta") or (
                    k == "weight" and v.ndim == 1):
                z = 1.0 + 0.2 * z
            elif k == "w_g":
                z = z / np.sqrt(v.shape[0])
            else:
                z = scale * z
            out[k] = z.astype(np.float32)
        return out
    return walk(shapes)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def load(tmod, params, key_map=None, batch_stats=None):
    tmod.load_state_dict(state_dict_from_jax(
        params, tmod.state_dict(), key_map, batch_stats), strict=True)
    return tmod


def init_shapes(jmod, *inputs, **static):
    """The variables' shapes; ``static`` keywords stay Python values."""
    return jax.eval_shape(functools.partial(jmod.init, **static),
                          jax.random.PRNGKey(0), *inputs)


def pair(jmod, tmod, rng, *inputs, to_torch=nchw, batch_stats=None):
    """(JAX output, port output) on shared seeded weights; ``inputs`` are
    numpy arrays in the JAX layout, given to the port through
    ``to_torch``."""
    shapes = init_shapes(jmod, *inputs)
    params = randomized(shapes["params"], rng)
    variables = {"params": params}
    stats = None
    if "batch_stats" in shapes:
        stats = batch_stats(shapes["batch_stats"], rng)
        variables["batch_stats"] = stats
    load(tmod, params, batch_stats=stats).eval()
    want = jmod.apply(variables, *inputs)
    with torch.no_grad():
        got = tmod(*(to_torch(x) for x in inputs))
    return want, got


def kth_gap(logits, k):
    """Smallest gap between the k-th and (k+1)-th softmax score of each
    row of (N, E) logits."""
    s = torch.sort(torch.softmax(torch.as_tensor(logits).float(), -1), -1,
                   descending=True).values
    return (s[:, k - 1] - s[:, k]).min().item()


def routing_gaps(model):
    """Hooks every router of ``model``; returns the list the gaps of its
    forwards go to."""
    gaps = []

    def hook(mod, inputs, _):
        gaps.append(kth_gap(mod.logits(*inputs), mod.k))

    for m in model.modules():
        if hasattr(m, "logits") and hasattr(m, "k"):
            m.register_forward_hook(hook)
    return gaps
