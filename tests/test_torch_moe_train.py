"""The MoE families' training path in the port (``ops/moe.py``,
``models/moce_ir.py``, ``moce_ir_patch.py``, ``igmoce_ir.py``,
``lumisense_moe.py``) against the JAX package's ``train=True`` apply, on
the same weights and the same noise (``tests/moe_parity.py``
``same_noise``: one seeded stream fed to ``jax.random.normal`` and the
port's ``routing_noise``; the test checks both drew the same shapes), in
fp32 (JAX at "highest" matmul precision, torch with TF32 off). MEASNet's
and the train step's are in tests/test_torch_moe_train_step.py.

Tolerances, those of the neighbouring family tests (tests/family_parity.py):
rtol=1e-4, atol=1e-5 for modules, gates and losses; whole models at
atol=1e-5 x the largest |output|. Every router's noisy pick has a gap
between its k-th and (k+1)-th softmax score above 1e-5 (``GAP_MIN``), so a
pick cannot flip between the packages.

* ``importance_loss`` and ``load_loss``, with and without the complexity
  bias, and with ties in the noisy logits.
* ``RoutingFunction`` and ``PatchRoutingFunction`` in training: gates,
  picks and aux; ``TokenMoE`` in training: output and balance loss; a
  router without a generator raises.
* Whole models with ``train=True``: MoCE-IR (``rank_type="spread"``,
  ``with_complexity=True``, top-1) plain and on the plain K1/K2 path
  (``fused_block``), the patch model, IGMoCE-IR and LumiSenseMoE, three
  decoder blocks each: the output and ``aux_loss``.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    ATOL,
    GAP_MIN,
    RTOL,
    kth_gap,
    load,
    nchw,
    nhwc,
    randomized,
)
from moe_parity import (  # noqa: F401  (fixtures, used by name)
    KEY,
    Stream,
    close,
    compiled,
    fp32_matmuls,
    gen,
    same_noise,
    traced_shapes,
)

from image_restoration_tpu.models import igmoce_ir as jg
from image_restoration_tpu.models import lumisense_moe as jl
from image_restoration_tpu.models import measnet as jmn
from image_restoration_tpu.models import moce_ir as jm
from image_restoration_tpu.models import moce_ir_patch as jp
from image_restoration_tpu.ops import moe as jmoe
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import measnet as tmn
from image_restoration_tpu_torch.models import moce_ir as tm
from image_restoration_tpu_torch.models import moce_ir_patch as tp
from image_restoration_tpu_torch.ops import moe as tmoe


@pytest.fixture
def noisy_gaps(monkeypatch):
    """The k-th/(k+1)-th gap of every noisy softmax the port's routers
    pick from."""
    gaps, gates = [], tmoe.noisy_topk_gates

    def record(logits, k, noise_std=None, noise=None):
        out = gates(logits, k, noise_std, noise)
        gaps.append(kth_gap(out[3].detach(), k))
        return out

    monkeypatch.setattr(tmoe, "noisy_topk_gates", record)
    return gaps


# ------------------------------------------------------------- ops/moe ----

@pytest.mark.parametrize("bias", [False, True], ids=["plain", "complexity"])
@pytest.mark.parametrize("k", [1, 2])
def test_balance_losses_match_jax(k, bias):
    rng = np.random.default_rng(k + 2 * bias)
    logits = rng.standard_normal((6, 4)).astype(np.float32)
    noisy = (logits + 0.25 * rng.standard_normal((6, 4))).astype(np.float32)
    comp = np.array([0.25, 0.5, 0.75, 1.0], np.float32) if bias else None
    soft = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want_i = jmoe.importance_loss(
        soft, None if comp is None else jnp.asarray(comp), 1.5)
    got_i = tmoe.importance_loss(
        torch.from_numpy(np.array(soft)),
        None if comp is None else torch.from_numpy(comp), 1.5)
    close(got_i, want_i)
    want_l = jmoe.load_loss(jnp.asarray(logits), jnp.asarray(noisy), 0.25, k)
    got_l = tmoe.load_loss(torch.from_numpy(logits), torch.from_numpy(noisy),
                           0.25, k)
    close(got_l, want_l)


def test_load_loss_with_ties():
    """Noisy rows with ties at the top, for second and everywhere; the
    thresholds stay within ~2 std of the logits, where 1 - Phi is not
    lost to fp32 cancellation (below ~1e-3 it is, in both packages)."""
    logits = np.array([[0.1, 0.4, -0.3, 0.2], [0.5, -0.2, 0.3, 0.0],
                       [0.0, 0.1, 0.2, 0.3]], np.float32)
    noisy = np.array([[0.2, 0.6, 0.6, 0.4],      # tie at the top
                      [0.9, 0.3, 0.1, 0.3],      # tie for second
                      [0.2, 0.2, 0.2, 0.2]], np.float32)
    for k in (1, 2, 3):
        want = jmoe.load_loss(jnp.asarray(logits), jnp.asarray(noisy), 0.5,
                              k)
        got = tmoe.load_loss(torch.from_numpy(logits),
                             torch.from_numpy(noisy), 0.5, k)
        close(got, want)


def test_routing_without_a_generator_raises():
    with pytest.raises(ValueError, match="torch.Generator"):
        tmoe.route(torch.zeros(2, 4), 1, train=True)
    with pytest.raises(ValueError, match="torch.Generator"):
        tmoe.routing_noise((2, 4), None)


# ------------------------------------------------------------- modules ----

def _module_pair(jmod, tmod, rng, *inputs):
    params = randomized(traced_shapes(jmod, *inputs)["params"], rng)
    return params, load(tmod, params)


@pytest.mark.parametrize("patch", [False, True], ids=["image", "patch"])
def test_routers_train_match_jax(patch, same_noise, noisy_gaps):
    rng = np.random.default_rng(30 + patch)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    f = rng.standard_normal((2, 32)).astype(np.float32)
    comp = (0.25, 0.5, 0.75, 1.0)
    if patch:
        jmod = jp.PatchRoutingFunction(16, 32, 4, 2, comp, 4, True)
        tmod = tp.PatchRoutingFunction(16, 32, 4, 2, 4, comp)
    else:
        jmod = jm.RoutingFunction(16, 32, 4, 2, comp, True)
        tmod = tm.RoutingFunction(16, 32, 4, 2, comp)
    params, tmod = _module_pair(jmod, tmod, rng, x, f)
    js, ts = same_noise(31)
    jg_, ji, jv, jaux = compiled(lambda p, a, b: jmod.apply(
        {"params": p}, a, b, train=True, rngs={"moe": KEY}), params, x, f)
    tg, ti, tv, taux = tmod(nchw(x), torch.from_numpy(f), True, gen())
    assert js.shapes == ts.shapes == [(8 if patch else 2, 4)]
    assert min(noisy_gaps) > GAP_MIN
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tg, jg_)
    close(tv, jv)
    close(taux, jaux)
    assert float(taux.detach()) > 0


def test_token_moe_train_matches_jax(same_noise):
    rng = np.random.default_rng(40)
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    prompt = rng.standard_normal((2, 8)).astype(np.float32)
    jmod = jmn.TokenMoE(8, 2.0)
    params = randomized(traced_shapes(jmod, x, prompt)["params"], rng)
    params["w_n"] = (0.3 * rng.standard_normal(params["w_n"].shape)).astype(
        np.float32)  # a learned noise scale (zero at the init)
    tmod = load(tmn.TokenMoE(8, 2.0), params)
    js, ts = same_noise(41)
    jy, jloss = compiled(lambda p, a, b: jmod.apply(
        {"params": p}, a, b, train=True, rngs={"moe": KEY}), params, x,
        prompt)
    ty, tloss = tmod(nchw(x), torch.from_numpy(prompt), True, gen())
    assert js.shapes == ts.shapes == [(60, 6)]
    close(ty, jy)
    close(tloss, jloss)


# --------------------------------------------------------- whole models ----

MOCE = dict(dim=16, levels=2, heads=(1, 2), num_blocks=(1, 1),
            num_dec_blocks=(3,), num_refinement_blocks=1, topk=1,
            rank_type="spread", depth_type="constant", stage_depth=(1,),
            with_complexity=True)
FAMILY = {  # (JAX class, port name, kwargs, input NHWC, key map)
    "moce_ir": (jm.MoCEIR, "moce_ir", MOCE, (2, 16, 20, 3),
                tm.moce_key_map),
    "moce_ir_patch": (jp.MoCEIRPatch, "moce_ir_patch",
                      dict(dim=16, levels=2, heads=(1, 2), num_blocks=(1, 1),
                           num_dec_blocks=(3,), patch_size=4,
                           with_complexity=True, rank_type="spread"),
                      (2, 16, 16, 3), None),
    "igmoce_ir": (jg.IGMoCEIR, "igmoce_ir",
                  dict(dim=16, levels=2, heads=(1, 1), num_blocks=(1, 1),
                       num_dec_blocks=(3,), dilations=(1, 4),
                       with_complexity=True, rank_type="spread"),
                  (2, 16, 16, 3), None),
    "lumisense_moe": (jl.LumiSenseMoEIR, "lumisense_moe",
                      dict(dim=16, levels=2, heads=(1, 1), num_blocks=(1, 1),
                           num_dec_blocks=(3,), topk=2),
                      (2, 16, 16, 3), None),
}


@functools.lru_cache(maxsize=None)
def _jax_train(name):
    """(params, x, output, aux_loss, noise shapes) of the JAX model's
    ``train=True`` forward on seeded weights and stream-fed noise. One
    trace and one compile: ``init_with_output`` runs the train forward,
    and each ``param`` is drawn at trace time by ``randomized``'s rule."""
    jcls, _, kw, shape, _ = FAMILY[name]
    rng = np.random.default_rng(50)
    x = rng.random(shape, dtype=np.float32)
    jnet = jcls(**kw)
    js = Stream(51)
    normal, param = jax.random.normal, nn.Module.param

    def seeded(self, pname, init_fn, *args, **kwargs):
        value = randomized({pname: jax.ShapeDtypeStruct(
            tuple(args[0]), jnp.float32)}, rng)[pname]
        return param(self, pname, lambda *_: jnp.asarray(value), *args,
                     **kwargs)

    jax.random.normal = lambda key, shape=(), dtype=jnp.float32: \
        jnp.asarray(js.draw(shape), dtype)
    nn.Module.param = seeded
    try:
        with jax.default_matmul_precision("highest"):
            (out, aux), variables = compiled(
                lambda a: jnet.init_with_output(
                    {"params": KEY, "moe": KEY}, a, train=True),
                jnp.asarray(x))
    finally:
        jax.random.normal, nn.Module.param = normal, param
    params = jax.tree.map(np.array, dict(variables["params"]))
    return (params, x, np.asarray(out), float(aux["aux_loss"]),
            tuple(js.shapes))


@pytest.mark.parametrize("name,fused", [
    ("moce_ir", False), ("moce_ir", True), ("moce_ir_patch", False),
    ("igmoce_ir", False), ("lumisense_moe", False)],
    ids=["moce_ir", "moce_ir-fused", "moce_ir_patch", "igmoce_ir",
         "lumisense_moe"])
def test_model_train_matches_jax(name, fused, same_noise, noisy_gaps):
    params, x, want, want_aux, shapes = _jax_train(name)
    _, port, kw, _, key_map = FAMILY[name]
    kw = dict(kw, fused_block=True) if fused else kw
    tnet = load(get_model(port, **kw), params, key_map).train()
    _, ts = same_noise(51)
    out, aux = tnet(nchw(x), train=True, generator=gen())
    assert tuple(ts.shapes) == shapes and len(shapes) == 3
    assert min(noisy_gaps) > GAP_MIN
    assert out.dtype == torch.float32 and set(aux) == {"aux_loss"}
    np.testing.assert_allclose(nhwc(out.detach()), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())
    close(aux["aux_loss"], want_aux)
    with torch.no_grad():  # eval draws nothing and returns the image alone
        assert tnet.eval()(nchw(x)).shape == out.shape
    assert len(ts.shapes) == 3
