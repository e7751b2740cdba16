"""MEASNet's and the trainer's MoE training path against the JAX package,
on the same weights and the same noise (``tests/moe_parity.py``
``same_noise``), fp32 (JAX at "highest", torch with TF32 off); the
routers' and the MoCE models' are in tests/test_torch_moe_train.py.

* MEASNet (dim 8, a block a level, 64x64, batch 2) with ``train=True``
  against ``apply(train=True, mutable=["batch_stats"])``: the output
  (atol=2e-4, as tests/test_torch_measnet.py), ``aux_loss`` (rtol=1e-4,
  atol=1e-5) and the six running statistics FD's BatchNorms update
  (each moved from its seeded value).
* One ``make_train_step`` step of a small MoCE-IR against the JAX step:
  loss, aux, every gradient and the updated parameters. The optimizer is
  SGD with momentum, whose trace after one step is the gradient (read
  from the optimizer state, as tests/test_torch_train.py reads Adam's):
  Adam's first step moves every parameter by about its learning rate
  whatever the gradient's size, so gradients near its eps (~1e-9 here)
  would decide parameters by their rounding. Gradients at atol 1e-5 x the
  largest gradient of the model (a tensor whose gradients are ~1e-4 of
  that carries the rounding of the sums upstream of it); parameters at
  rtol=1e-4, atol=1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
from family_parity import ATOL, RTOL, load, nchw, nhwc, randomized
from moe_parity import (  # noqa: F401  (fixtures, used by name)
    KEY,
    FAST,
    close,
    compiled,
    fp32_matmuls,
    gen,
    same_noise,
    traced_shapes,
)

from image_restoration_tpu.models import measnet as jmn
from image_restoration_tpu.models import moce_ir as jm
from image_restoration_tpu.train import trainer as JT
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import moce_ir as tm
from image_restoration_tpu_torch.train import trainer as TT
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax


MEASNET = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
               heads=(1, 2, 4, 8))


def _seeded_stats(shapes, rng):
    """BatchNorm running statistics: means near 0, variances in [0.5, ~3]
    (tests/test_torch_measnet.py's)."""
    return {k: _seeded_stats(v, rng) if isinstance(v, dict) else (
        0.1 * rng.standard_normal(v.shape) if k == "running_mean"
        else 0.5 + np.abs(rng.standard_normal(v.shape))).astype(np.float32)
        for k, v in shapes.items()}


def test_measnet_train_matches_jax(same_noise):
    rng = np.random.default_rng(60)
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    jnet = jmn.MEASNet(**MEASNET)
    shapes = traced_shapes(jnet, jnp.asarray(x))
    params = randomized(shapes["params"], rng)
    for name in ("stpg_g_mese1", "stpg_g_mese2", "stpg_g_mese3"):
        w_n = params[name]["model"]["w_n"]
        params[name]["model"]["w_n"] = (0.2 * rng.standard_normal(
            w_n.shape)).astype(np.float32)
    stats = _seeded_stats(shapes["batch_stats"], rng)
    tnet = load(get_model("measnet", **MEASNET), params,
                batch_stats=stats).train()
    js, ts = same_noise(61)
    (want, jaux), mutated = compiled(lambda v, a: jnet.apply(
        v, a, train=True, mutable=["batch_stats"], rngs={"moe": KEY}),
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    out, aux = tnet(nchw(x), train=True, generator=gen())
    assert js.shapes == ts.shapes and len(ts.shapes) == 3
    np.testing.assert_allclose(nhwc(out.detach()), np.asarray(want), rtol=0,
                               atol=2e-4)
    close(aux["aux_loss"], jaux["aux_loss"])
    sd = tnet.state_dict()
    new = state_dict_from_jax(params, sd, batch_stats=jax.tree.map(
        np.array, mutated["batch_stats"]))
    old = state_dict_from_jax(params, sd, batch_stats=stats)
    moved = [k for k in new if k.endswith(("running_mean", "running_var"))]
    assert len(moved) == 6
    for k in moved:
        assert not np.allclose(new[k].numpy(), old[k].numpy()), k
        np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


# ----------------------------------------------------------- train step ----

STEP = dict(dim=16, levels=2, heads=(1, 2), num_blocks=(1, 1),
            num_dec_blocks=(1,), num_refinement_blocks=1, num_experts=3,
            topk=2,
            rank_type="spread", depth_type="constant", stage_depth=(1,),
            with_complexity=True)


def test_train_step_matches_jax(same_noise):
    rng = np.random.default_rng(70)
    gt = rng.random((2, 16, 16, 3)).astype(np.float32)
    lq = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1).astype(
        np.float32)
    jnet = jm.MoCEIR(**STEP)
    params = randomized(traced_shapes(jnet, jnp.asarray(lq))["params"], rng)
    tnet = load(get_model("moce_ir", **STEP), params, tm.moce_key_map)
    kw = dict(learning_rate=0.1, loss={"l1": 1.0}, aux_loss_weight=0.01,
              optimizer="sgd", apply_kwargs={"train": True})
    jcfg, tcfg = JT.TrainerConfig(**kw), TT.TrainerConfig(**kw)
    jtx, ttx = JT.make_optimizer(jcfg), TT.make_optimizer(tcfg)
    jstate = JT.TrainState.create(params, jtx)
    tstate = TT.TrainState.create(tnet, ttx)
    js, ts = same_noise(71)
    jstep = JT.make_train_step(jnet, jtx, jcfg, donate=False)
    jb = {"lq": jnp.asarray(lq), "gt": jnp.asarray(gt)}
    jstate, jlogs = jstep.lower(jstate, jb, KEY).compile(FAST)(jstate, jb,
                                                                KEY)
    tstate, tlogs = TT.make_train_step(tnet, ttx, tcfg)(
        tstate, {"lq": nchw(lq), "gt": nchw(gt)}, gen())
    assert js.shapes == ts.shapes and len(ts.shapes) == 1
    assert set(tlogs) == set(jlogs) and "aux" in tlogs
    for k in jlogs:
        close(tlogs[k], jlogs[k])
    like = tnet.state_dict()
    todo = [jstate.opt_state]  # the momentum trace: g after one step
    while not hasattr(todo[-1], "trace"):
        node = todo.pop()
        todo.extend(node if isinstance(node, tuple) else ())
    want_g = state_dict_from_jax(jax.tree.map(np.array, todo[-1].trace),
                                 like, tm.moce_key_map)
    scale = max(float(w.abs().max()) for w in want_g.values())
    for k, g in tstate.opt_state["trace"].items():
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), rtol=RTOL,
                                   atol=ATOL * scale, err_msg=k)
    want_p = state_dict_from_jax(jax.tree.map(np.array, jstate.params),
                                 like, tm.moce_key_map)
    for k, p in tnet.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_p[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
