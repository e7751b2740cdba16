"""The port's FCM (``ops/fusion_blocks.py``) against the JAX package's, on
the same weights and BatchNorm statistics.

Each JAX module gets seeded random parameters and running statistics
(``tests/family_parity.py`` ``randomized`` and ``seeded_stats``), loaded
into the port through ``state_dict_from_jax`` with ``fcm_key_map`` (the
statistics through ``batch_stats``), and both run the same seeded numpy
inputs in fp32; the port takes NCHW, JAX NHWC. In training both normalise
with the batch's statistics and update the running ones (JAX with
``mutable=["batch_stats"]``).

Tolerance (``family_parity.hold``): relative L2 <= 1e-5 and max |error|
<= 1e-5 x max |JAX output|, for the outputs, the updated statistics and
the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    grads_close, hold, init_shapes, load, nchw, nhwc, randomized,
    seeded_stats,
)

from image_restoration_tpu.ops import fusion_blocks as jf
from image_restoration_tpu_torch.ops import fusion_blocks as tf
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _variables(jmod, x, rng):
    shapes = init_shapes(jmod, x)
    return {"params": randomized(shapes["params"], rng),
            "batch_stats": seeded_stats(shapes["batch_stats"], rng)}


def _port(tmod, v, key_map=tf.fcm_key_map):
    return load(tmod, v["params"], key_map, v["batch_stats"])


def _stats_hold(tmod, new, key_map=tf.fcm_key_map):
    want = state_dict_from_jax(new["params"], tmod.state_dict(), key_map,
                               jax.tree.map(np.array, new["batch_stats"]))
    n = 0
    for k, t in tmod.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            hold(t.numpy(), want[k].numpy())
            n += 1
    assert n


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2)])
def test_conv_bn_silu(kernel, stride, train):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    jmod = jf.ConvBNSiLU(12, kernel, stride)
    tmod = tf.ConvBNSiLU(8, 12, kernel, stride)
    v = _variables(jmod, x, rng)
    _port(tmod, v, None)
    if train:
        want, new = jmod.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(v, x)
    with torch.no_grad():
        got = tmod(nchw(x), train=train)
    hold(nhwc(got), want)
    if train:
        _stats_hold(tmod, {**v, **new}, None)


@pytest.mark.parametrize("dim,hw", [(16, (12, 10)), (48, (9, 7))])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fcm(dim, hw, train):
    """FCM in eval (running statistics) and in training (the batch's,
    every BatchNorm's running statistics updated as JAX updates them)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, *hw, dim)).astype(np.float32)
    jmod, tmod = jf.FCM(dim), tf.FCM(dim)
    v = _variables(jmod, x, rng)
    _port(tmod, v)
    if train:
        want, new = jmod.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(v, x)
    with torch.no_grad():
        got = tmod(nchw(x), train=train)
    hold(nhwc(got), want)
    if train:
        _stats_hold(tmod, {**v, **new})


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fcm_gradients(train):
    """Input and parameter gradients of sum(out * g) against ``jax.grad``,
    in eval and in training (through the batch statistics)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 10, 16)).astype(np.float32)
    jmod, tmod = jf.FCM(16), tf.FCM(16)
    v = _variables(jmod, x, rng)
    _port(tmod, v)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def loss(p, a):
        var = {**v, "params": p}
        if train:
            out, _ = jmod.apply(var, a, train=True, mutable=["batch_stats"])
        else:
            out = jmod.apply(var, a)
        return jnp.sum(out * g)

    jgp, jgx = jax.grad(loss, argnums=(0, 1))(v["params"], x)
    xt = nchw(x).requires_grad_(True)
    (tmod(xt, train=train) * nchw(g)).sum().backward()
    hold(nhwc(xt.grad), jgx)
    grads_close(tmod, jgp, tf.fcm_key_map)


def test_fcm_key_map_takes_reference_names():
    """A reference FCM state_dict (``spatial.conv1``, ``spatial.bn``,
    ``channel.dconv``) maps onto the JAX paths, and the port's own keys
    are the reference's."""
    assert tf.fcm_key_map("spatial.conv1.weight") == "spatial_conv1.weight"
    assert tf.fcm_key_map("spatial.bn.running_var") == \
        "spatial_bn.running_var"
    assert tf.fcm_key_map("channel.dconv.bias") == "channel_dwconv.bias"
    keys = set(tf.FCM(16).state_dict())
    assert {"spatial.conv1.weight", "spatial.bn.running_mean",
            "channel.dwconv.weight", "conv3.bn.weight"} <= keys
