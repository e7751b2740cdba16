"""The port's seeded initial parameters against the JAX package's init, for
every ported registry model at a small configuration.

What JAX draws is read from the JAX model itself: ``flax.linen.Module``'s
``param`` and ``variable`` are wrapped for the duration of one
``jax.eval_shape(model.init, ...)``, which records each parameter's
initializer and shape (and each ``batch_stats`` variable's init function),
handing the traced forward zeros of that shape: the init is neither run,
traced nor compiled. Initializers that draw nothing
(zeros, ones, constants such as ViG's layer scales and RetinaNet's
focal-prior class bias, MoCE's Laplacian high-pass, the AdaptIR
adapters' zero ``tail``, MyModel's zero ``beta``/``gamma``) are evaluated
and held exactly. The random ones
are held to their distribution: flax's
``variance_scaling`` (``lecun_normal`` for every conv and dense kernel)
gives a normal truncated at 2 stddev, stddev = sqrt(scale / fan) /
0.8796..., with the fan JAX computes for that shape, and its uniform
distribution (SRConvNet's kernel bank, TransWeather's transposed convs) a
uniform within +-sqrt(3 scale / fan); ``normal(s)`` a normal of std s
(IPT's ``query_embed`` and ``position_encoding``); the AdaptIR adapters'
local ``kaiming`` (a=sqrt(5)), MyModel's too, a uniform within +-1 /
sqrt(shape[1]).
Everything goes through the weight bridge
(``utils/jax_bridge.py`` ``state_dict_from_jax``, the model's registered
key map), so each port tensor meets the JAX leaf it is loaded from.

Tolerances (sampling, for the port's one seeded draw of n values from a
distribution of std sigma; both are exact properties of the draw, not
of rounding): every tensor of a truncated draw lies within its
truncation bound; a tensor of at least 256 values has its mean within
6 sigma / sqrt(n) of 0 and its std within 5 / sqrt(n) of sigma,
relatively (about 7 standard errors of a sample std of a normal; a
uniform's is smaller). torch's default
conv and linear init (std sigma / sqrt(3), uniform biases) fails both.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import traceable_retinanet
from jax._src.nn.initializers import _compute_fans

from image_restoration_tpu.models import get_model as jax_get_model
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models.registry import KEY_MAPS
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

TRUNC = 0.87962566103423978  # flax's truncated-normal std rescale
# registry name: (small configuration, NHWC input of the JAX init)
MODELS = {
    "restormer": (dict(dim=16, num_blocks=(1, 1, 1, 1),
                       num_refinement_blocks=1), (1, 16, 16, 3)),
    "drsformer": (dict(dim=16, num_blocks=(1, 1, 1, 1)), (1, 16, 16, 3)),
    "adair": (dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1),
              (1, 32, 24, 3)),
    "cg_ir": (dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                   context_dim=16, num_scales=2), (1, 32, 32, 3)),
    "measnet": (dict(dim=8, num_blocks=(1, 1, 1, 1),
                     num_refinement_blocks=1), (1, 64, 64, 3)),
    "nerd_rain": (dict(dim=8, num_blocks=(1, 1, 1), heads=(1, 2, 4)),
                  (1, 32, 32, 3)),
    "moce_ir": (dict(dim=16, levels=3, heads=(1, 2, 4), num_blocks=(1, 1, 1),
                     num_dec_blocks=(1, 1), num_refinement_blocks=1,
                     rank_type="spread", with_complexity=True),
                (1, 16, 16, 3)),
    "igmoce_ir": (dict(dim=16, num_blocks=(1, 1, 1, 1), dilations=(1, 4)),
                  (1, 16, 16, 3)),
    "lumisense_moe": (dict(dim=16, num_blocks=(1, 1, 1, 1)), (1, 16, 16, 3)),
    "moce_ir_patch": (dict(dim=16, num_blocks=(1, 1, 1)), (1, 32, 32, 3)),
    "lsnet": (dict(img_size=64, patch_size=8, num_classes=10,
                   embed_dim=(16, 32, 48, 64), key_dim=(8, 8, 8, 8),
                   depth=(1, 2, 2, 2), num_heads=(2, 2, 2, 2)),
              (1, 64, 64, 3)),
    "srconvnet": (dict(dim=16, n_blocks=1, num_heads=2, num_kernels=4,
                       scale=2), (1, 16, 16, 3)),
    "transweather": (dict(embed_dims=(16, 32, 40, 64), num_heads=(1, 2, 2, 2),
                          depths=(1, 1, 1, 1), dec_depth=1, dec_heads=2),
                     (1, 64, 64, 3)),
    "darkir": (dict(width=8, enc_blk_nums=(1, 1, 1), middle_blk_num_enc=1,
                    middle_blk_num_dec=1, dec_blk_nums=(1, 1, 1)),
               (1, 32, 32, 3)),
    "vig": (dict(img_size=32, patch_size=4, depth=1, embed_dim=32,
                 num_classes=10, use_swiglu=True, init_values=0.1),
            (1, 32, 32, 3)),
    "vig_h": (dict(depths=(1, 1), dims=(16, 32), num_heads=(2, 4),
                   num_classes=10), (1, 32, 32, 3)),
    "retinanet_lsnet": (dict(embed_dim=(16, 32, 48, 64), depth=(1, 2, 2, 2),
                             img_size=64, fpn_dim=32, num_classes=5),
                        (1, 64, 64, 3)),
    "semanticfpn_lsnet": (dict(embed_dim=(16, 32, 48, 64),
                               depth=(1, 2, 2, 2), img_size=64, fpn_dim=32,
                               seg_dim=32, num_classes=5), (1, 64, 64, 3)),
    "ipt": (dict(n_feats=24), (1, 48, 48, 3)),
    "edt": (dict(embed_dim=60), (1, 48, 48, 3)),
    "edt_adaptir": (dict(de_type="denoise_30", embed_dim=60),
                    (1, 96, 96, 3)),
    "rectiformer": (dict(dim=8, num_encoder_blocks=(1, 1, 1, 1),
                         num_decoder_blocks=(1, 1, 1, 1),
                         num_refinement_blocks=1, context_dim=16),
                    (1, 64, 64, 3)),
    "fpn_restormer": (dict(dim=8, num_blocks=(1, 1, 1, 1),
                           num_refinement_blocks=1), (1, 32, 32, 3)),
    "mymodel": (dict(dim=16, levels=2, heads=(1, 2), num_blocks=(1, 1),
                     num_dec_blocks=(1,), stage_depth=(1,)),
                (1, 32, 32, 3)),
    "sfsnid": (dict(num_res=1, base_channel=16), (1, 32, 32, 3)),
    "hilo": (dict(dim=16, num_heads=4), (1, 8, 8, 16)),
    "pinn": (dict(), (1, 16, 16, 3)),
}


def _closure(fn):
    import inspect

    return inspect.getclosurevars(fn).nonlocals


def _draws(init_fn, shape, dtype=jnp.float32):
    """(fixed value or None, std, truncation bound) of what ``init_fn``
    draws at ``shape``: a value for an initializer that draws nothing,
    else the std of its distribution and, for a truncated one, its
    bound (inf otherwise)."""
    name = getattr(init_fn, "__qualname__", "")
    if name.startswith("variance_scaling."):
        c = _closure(init_fn)
        assert c["distribution"] in ("truncated_normal", "uniform"), c
        fan_in, fan_out = _compute_fans(shape, c["in_axis"], c["out_axis"],
                                        c["batch_axis"])
        fan = {"fan_in": fan_in, "fan_out": fan_out,
               "fan_avg": (fan_in + fan_out) / 2}[c["mode"]]
        std = float(np.sqrt(c["scale"] / fan))
        if c["distribution"] == "uniform":  # in +-sqrt(3) std
            return None, std, float(np.sqrt(3.0)) * std
        return None, std, 2 * std / TRUNC
    if name.startswith("normal."):
        return None, float(_closure(init_fn)["stddev"]), np.inf
    if name.endswith(("AdaptIRAdapter.__call__.<locals>.kaiming",
                      "MyAdaptIR.__call__.<locals>.kaiming")):
        # the adapters' low-rank factors: kaiming_uniform(a=sqrt(5)),
        # uniform in +-sqrt(6 / ((1 + 5) shape[1]))
        bound = float(np.sqrt(6.0 / (6.0 * shape[1])))
        return None, bound / float(np.sqrt(3.0)), bound
    if init_fn in (nn.initializers.zeros, nn.initializers.ones):
        value = float(init_fn is nn.initializers.ones)
        return np.full(shape, value, np.float32), np.nan, np.nan
    if name.startswith("constant."):
        return (np.full(shape, _closure(init_fn)["value"], np.float32),
                np.nan, np.nan)
    a = np.asarray(init_fn(jax.random.PRNGKey(1), shape, dtype))
    b = np.asarray(init_fn(jax.random.PRNGKey(2), shape, dtype))
    assert np.array_equal(a, b), f"{name} draws: no rule for it here"
    return a, np.nan, np.nan


@functools.lru_cache(maxsize=None)
def _jax_inits(name):
    """Three trees per collection ("params", "batch_stats") in the JAX
    layout: the fixed values (NaN where the init draws), and each random
    leaf's std and truncation bound (NaN where it draws nothing), from one
    ``eval_shape`` of the JAX init with ``param``/``variable`` recorded."""
    cfg, shape = MODELS[name]
    jnet = jax_get_model(name, **cfg)
    trees = {c: ({}, {}, {}) for c in ("params", "batch_stats")}
    param, variable = nn.Module.param, nn.Module.variable

    def put(col, path, value, std, bound):
        for tree, leaf in zip(trees[col], (value, std, bound)):
            for k in path[:-1]:
                tree = tree.setdefault(k, {})
            tree[path[-1]] = leaf

    def record(col, path, value, std, bound):
        shape = value.shape if value is not None else path[-1]
        path = path[:-1]
        put(col, path,
            np.full(shape, np.nan, np.float32) if value is None
            else value.astype(np.float32),
            np.full(shape, std, np.float32),
            np.full(shape, bound, np.float32))

    seen = []

    def rec_param(self, pname, init_fn, *args, **kw):
        seen.append(("params", self.path + (pname,), init_fn, args))
        return jnp.zeros(*args)  # the forward's shapes; nothing is drawn

    def rec_variable(self, col, vname, init_fn=None, *args, **kw):
        if col == "batch_stats":
            seen.append((col, self.path + (vname,), init_fn, args))
        return variable(self, col, vname, init_fn, *args, **kw)

    nn.Module.param, nn.Module.variable = rec_param, rec_variable
    try:
        with traceable_retinanet():
            jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros(shape))
    finally:
        nn.Module.param, nn.Module.variable = param, variable
    for col, path, init_fn, args in seen:
        if col == "batch_stats":
            value, std, bound = np.asarray(init_fn(*args)), np.nan, np.nan
        else:
            value, std, bound = _draws(init_fn, *args)
        record(col, path + (tuple(args[0]) if value is None else None,),
               value, std, bound)
    return trees


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_matches_jax(name):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        port = get_model(name, **MODELS[name][0])
    like = port.state_dict()
    params, stats = _jax_inits(name)["params"], _jax_inits(name)["batch_stats"]
    fixed, stds, bounds = (state_dict_from_jax(
        params[i], like, KEY_MAPS.get(name),
        stats[i] if stats[0] else None) for i in range(3))
    n_random = n_stats = 0
    for key, t in like.items():
        if key.endswith("num_batches_tracked") or (
                KEY_MAPS.get(name) and KEY_MAPS[name](key) is None):
            continue  # a buffer with no JAX leaf (LSNet's index table)
        t, want = t.double().numpy(), fixed[key].double().numpy()
        if not np.isnan(want).any():
            np.testing.assert_array_equal(t, want, err_msg=key)
            continue
        n_random += 1
        std, bound = float(stds[key].flatten()[0]), float(
            bounds[key].flatten()[0])
        assert np.abs(t).max() <= bound * (1 + 1e-6), (key, bound)
        n = t.size
        if n >= 256:
            n_stats += 1
            assert abs(t.mean()) <= 6 * std / np.sqrt(n), (key, t.mean(), std)
            assert abs(t.std() / std - 1) <= 5 / np.sqrt(n), (
                key, t.std(), std)
    assert n_random and n_stats, (n_random, n_stats)
