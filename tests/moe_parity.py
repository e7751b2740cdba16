"""Shared helpers of the MoE training parity tests
(tests/test_torch_moe_train.py, tests/test_torch_moe_train_step.py): one
noise stream fed to both packages, the JAX side's fast compile, and the
variables' shapes from a trace that draws nothing.

``same_noise`` replaces ``jax.random.normal`` (where the JAX routers draw,
``ops/moe.py:39`` and ``measnet.py:141-142``) and the port's
``ops/moe.py`` ``routing_noise`` for the test's duration; each pops
arrays, in call order, from its own copy of one seeded numpy stream.
Neither package is edited.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import ATOL, RTOL, nhwc

from image_restoration_tpu_torch.ops import moe as tmoe

KEY = jax.random.PRNGKey(0)  # the JAX side's "moe" rng; its draws are fed
# XLA:CPU options that cut the JAX side's compile time (LLVM's optimisation
# off); the comparisons hold at the same tolerances either way
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    """``fn`` jitted, compiled with ``FAST`` and called on ``args``."""
    return jax.jit(fn).lower(*args).compile(FAST)(*args)


def traced_shapes(jmod, *inputs):
    """{"params": shapes, "batch_stats": shapes} of ``jmod``'s variables,
    from a trace of its forward that hands each ``param`` zeros of its
    shape instead of drawing it (the draws cost more to trace than the
    forward)."""
    seen = {"params": {}}
    param = nn.Module.param

    def record(self, name, init_fn, *args, **kw):
        node = seen["params"]
        for k in self.path:
            node = node.setdefault(k, {})
        node[name] = jax.ShapeDtypeStruct(tuple(args[0]), jnp.float32)
        return jnp.zeros(*args)

    nn.Module.param = record
    try:
        out = jax.eval_shape(jmod.init, KEY, *inputs)
    finally:
        nn.Module.param = param
    if "batch_stats" in out:
        seen["batch_stats"] = out["batch_stats"]
    return seen


@pytest.fixture(autouse=True)
def fp32_matmuls():
    """fp32 on both sides: TF32 off in torch, "highest" in JAX (autouse
    where imported)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


class Stream:
    """Standard normal fp32 arrays popped in call order from a seeded numpy
    stream; ``shapes`` records what was drawn."""

    def __init__(self, seed):
        self.rng, self.shapes = np.random.default_rng(seed), []

    def draw(self, shape):
        self.shapes.append(tuple(shape))
        return self.rng.standard_normal(tuple(shape)).astype(np.float32)


@pytest.fixture
def same_noise(monkeypatch):
    """``same_noise(seed)`` -> (JAX stream, port stream): from then on both
    packages' routing noise comes from the same seeded stream. The port's
    draw still needs a ``torch.Generator``, as ``routing_noise`` does."""
    def start(seed):
        js, ts = Stream(seed), Stream(seed)
        monkeypatch.setattr(
            jax.random, "normal",
            lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
                js.draw(shape), dtype))

        def port(shape, generator, device=None):
            assert isinstance(generator, torch.Generator)
            return torch.from_numpy(ts.draw(shape)).to(device)

        monkeypatch.setattr(tmoe, "routing_noise", port)
        return js, ts

    return start




def gen():
    """A seeded CPU generator: the port's routers need one, though the
    stream feeds their draws."""
    return torch.Generator().manual_seed(0)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach()
    got = nhwc(got) if got.ndim == 4 else got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)
