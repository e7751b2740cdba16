"""Shared helpers of the port's parity tests of the model families
(tests/test_torch_cg_ir.py, test_torch_nerd_rain.py, test_torch_measnet.py,
the MoCE family's, test_torch_family_recipes.py, test_torch_hogformer.py,
test_torch_mwformer.py, the GLA, ViG, HierViG and dense LSNet files,
the AdaptIR IPT and EDT files):
seeded parameter trees, the JAX -> port weight load, a module pair run on
the same numpy inputs in fp32 (JAX at "highest" matmul precision, torch
with TF32 off), one train step of both packages, the MoE routers' pick
margins, and a context in which JAX's RetinaNet head traces."""

import contextlib
import functools
import os

import jax
import numpy as np
import torch

from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

# The tier-1 command runs the suite in pytest-xdist workers, one process a
# worker, and torch takes one intra-op thread a core in each: 6 workers on
# 8 cores ran ~48 torch threads. Every worker imports this module while it
# collects, so under xdist each worker's torch takes its share of the cores
# (the six slowest family files in 6 workers on an 8-core CPU: 272 s at
# torch's default, 166 s at one thread a worker).
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))

# The first multithreaded ``torch.exp`` of a process on the CPU (torch
# 2.13) can return values off by up to ~1e-4 relative in some threads'
# slices; every later call is exact to fp32 rounding. A parity test whose
# first exp is a compared one (a GLA chunk's decays) then fails at random,
# so every worker takes its first exp here.
torch.exp(torch.zeros(1 << 18))

RTOL, ATOL = 1e-4, 1e-5
# Least gap between the k-th and (k+1)-th softmax score of a MoE router for
# its pick to be the same in both packages: fp32 rounding is ~1e-7.
GAP_MIN = 1e-5


def hold(got, want, tol=1e-5, scale=None):
    """``got`` (numpy, the JAX layout) against the JAX ``want``: relative
    L2 at most ``tol`` and max |error| at most ``tol`` x ``scale``, by
    default max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= tol, f"relative L2 {rel:.3e} > {tol:g}"
    assert err.max() <= tol * scale, (
        f"max |error| {err.max():.3e} > {tol:g} x {scale:.3e}")


def bf16_within_three_times(got16, jax16, jax32):
    """The port's bf16 output against JAX's fp32 within 3x the JAX bf16
    output's error against it, in max and mean (tests/test_tpu_kernels.py's
    rule)."""
    jax32 = np.asarray(jax32, np.float64)
    err_port = np.abs(np.asarray(got16, np.float64) - jax32)
    err_jax = np.abs(np.asarray(jax16, np.float64) - jax32)
    assert err_port.max() <= 3 * err_jax.max(), (err_port.max(),
                                                 err_jax.max())
    assert err_port.mean() <= 3 * err_jax.mean(), (err_port.mean(),
                                                   err_jax.mean())


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


def seeded_stats(tree, rng):
    """Seeded BatchNorm running statistics for a ``batch_stats`` tree (or
    its shapes): means near 0, variances near 1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = seeded_stats(v, rng)
        elif k == "running_var":
            out[k] = (1.0 + 0.3 * np.abs(rng.standard_normal(v.shape))
                      ).astype(np.float32)
        else:
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def seeded_adaptir(shapes, rng):
    """Seeded variables of an AdaptIR model or module from ``shapes``
    ({"params", "batch_stats"}): ``randomized``'s with ``seeded_stats``,
    every packed attention ``in_proj_weight`` at the fan-in scale
    (``randomized`` draws leaves it does not name at 0.5, which saturates
    the softmaxes) and every ``pha_fuse_weight`` a nonzero integer in
    [-2, 2]. The phase of an rfft2 coefficient that is real and negative
    (the DC and Nyquist ones) is +-pi by the sign of the rounding noise in
    its imaginary part (JAX's rfft2 leaves ~1e-9 there where torch's gives
    0), and only an integer weight maps both to one angle mod 2 pi."""
    def walk(tree):
        out = {}
        for k, t in tree.items():
            if isinstance(t, dict):
                out[k] = walk(t)
            elif k == "in_proj_weight":
                out[k] = (t / np.sqrt(2 * t.shape[1])).astype(np.float32)
            elif k == "pha_fuse_weight":
                out[k] = rng.choice([-2.0, -1.0, 1.0, 2.0],
                                    t.shape).astype(np.float32)
            else:
                out[k] = t
        return out

    v = {"params": walk(randomized(shapes["params"], rng))}
    if "batch_stats" in shapes:
        v["batch_stats"] = seeded_stats(shapes["batch_stats"], rng)
    return v


def grads_close(tmod, jgrads, key_map=None, skip=()):
    """Every parameter gradient of ``tmod`` (after a ``backward``) but
    those whose names end in one of ``skip`` against the JAX gradient tree
    ``jgrads``, within rtol 1e-4 and 1e-5 x the largest JAX gradient."""
    want = state_dict_from_jax(jax.tree.map(np.array, jgrads),
                               tmod.state_dict(), key_map)
    scale = max(float(w.abs().max()) for w in want.values())
    for k, p in tmod.named_parameters():
        if not (skip and k.endswith(tuple(skip))):
            np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                       rtol=RTOL, atol=ATOL * scale,
                                       err_msg=k)


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


class _NumpyLogOfFloats:
    """``jax.numpy`` whose ``log`` of a Python float is numpy's float32
    log (a concrete value); every other name is ``jax.numpy``'s."""

    def __getattr__(self, name):
        return getattr(jax.numpy, name)

    @staticmethod
    def log(x):
        if isinstance(x, float):
            return np.log(np.float32(x))
        return jax.numpy.log(x)


@contextlib.contextmanager
def traceable_retinanet():
    """JAX's ``RetinaNetHead`` takes ``float(-jnp.log((1 - 0.01) / 0.01))``
    in its ``__call__``; under a trace (``jit``, ``eval_shape``) that log
    is a tracer and ``float`` raises. Inside this context the JAX
    ``lsnet_dense`` module takes the log of a Python float from numpy;
    nothing else changes (``jax.ensure_compile_time_eval`` also lets it
    trace, but evaluates far more at trace time: ~50 s for a small model
    on the CPU)."""
    from image_restoration_tpu.models import lsnet_dense

    saved = lsnet_dense.jnp
    lsnet_dense.jnp = _NumpyLogOfFloats()
    try:
        yield
    finally:
        lsnet_dense.jnp = saved


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


def train_step_pair(jnet, tnet, params, batch, recipe, apply_kwargs=None,
                    recipe_kwargs=None, port_recipe_kwargs=None,
                    key_map=None, freeze=(), loss=None):
    """One SGD step (lr 0.1, momentum 0.9: the trace after one step is the
    gradient) of the JAX ``make_train_step`` and the port's on ``batch``
    (with the loss terms ``loss``, e.g. ``{"mse": 1.0}``, when given; the
    trainers' default L1 otherwise)
    (numpy, JAX layout; 4-d arrays go to the port as NCHW) from
    ``params``, which ``tnet`` holds already. Checks the logged terms at
    rtol 1e-4, atol 1e-5, every gradient at atol 1e-5 x the model's
    largest and the updated parameters at rtol 1e-4, atol 1e-5; returns
    the port's logs."""
    import jax.numpy as jnp

    from image_restoration_tpu.train import trainer as JT
    from image_restoration_tpu_torch.train import trainer as TT
    from moe_parity import FAST

    kw = dict(learning_rate=0.1, optimizer="sgd", recipe=recipe,
              apply_kwargs=apply_kwargs or {}, freeze_prefixes=tuple(freeze))
    if loss is not None:
        kw["loss"] = dict(loss)
    jcfg = JT.TrainerConfig(**kw, recipe_kwargs=recipe_kwargs or {})
    tcfg = TT.TrainerConfig(**kw, recipe_kwargs=port_recipe_kwargs or {})
    jtx, ttx = JT.make_optimizer(jcfg), TT.make_optimizer(tcfg)
    jstate = JT.TrainState.create(params, jtx)
    tstate = TT.TrainState.create(tnet, ttx)
    jstep = JT.make_train_step(jnet, jtx, jcfg, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    jstate, jlogs = jstep.lower(jstate, jb, key).compile(FAST)(jstate, jb,
                                                                key)
    tstate, tlogs = TT.make_train_step(tnet, ttx, tcfg)(tstate, {
        k: nchw(v) if v.ndim == 4 else torch.from_numpy(v)
        for k, v in batch.items()})
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), RTOL,
                                   ATOL, err_msg=k)
    like = tnet.state_dict()
    todo = [jstate.opt_state]  # the momentum trace: g after one step
    while not hasattr(todo[-1], "trace"):
        node = todo.pop()
        todo.extend(node if isinstance(node, tuple) else ())
    want_g = state_dict_from_jax(jax.tree.map(np.array, todo[-1].trace),
                                 like, key_map)
    scale = max(float(w.abs().max()) for w in want_g.values())
    for k, g in tstate.opt_state["trace"].items():
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), rtol=RTOL,
                                   atol=ATOL * scale, err_msg=k)
    want_p = state_dict_from_jax(jax.tree.map(np.array, jstate.params),
                                 like, key_map)
    for k, p in tnet.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_p[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    return tlogs
