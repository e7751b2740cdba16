"""The port's frequency MoE layer (``ops/freq_moe.py``) against the JAX
package's, on the same weights and, in training, the same noise.

Each JAX module gets seeded random parameters (``tests/family_parity.py``
``randomized``), loaded into the port through ``state_dict_from_jax``, and
both run the same seeded numpy inputs in fp32 (JAX at "highest" matmul
precision, torch with TF32 off); the port takes NCHW, JAX NHWC. The
routing noise of training comes from one seeded stream fed to both
(``tests/moe_parity.py`` ``same_noise``).

Tolerance (``family_parity.hold``): relative L2 <= 1e-5 and max |error|
<= 1e-5 x max |JAX output|, outputs and gradients; the routers' top-k
picks must have a softmax gap above ``family_parity.GAP_MIN`` between the
k-th and (k+1)-th expert, so that rounding cannot flip them.

The global experts rebuild each rfft2 coefficient from its magnitude and
phase, so their forward is continuous; their inputs are odd-sided maps
with a positive DC anyway, where no coefficient is exactly real and
negative. The two reference quirks are held as JAX computes them: the
energy histogram's centred grid laid on the unshifted spectrum, with the
largest radius in no bin, and the load loss of (logits, logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    GAP_MIN, grads_close, hold, init_shapes, kth_gap, load, nchw, nhwc,
    randomized,
)
from moe_parity import KEY, gen, same_noise  # noqa: F401

from image_restoration_tpu.ops import freq_moe as jf
from image_restoration_tpu_torch.ops import freq_moe as tf


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _x(rng, c, h=11, w=9, b=2, offset=1.0):
    return (rng.standard_normal((b, h, w, c)) + offset).astype(np.float32)


EXPERTS = {"high_local": (jf.HighFreqLocal, tf.HighFreqLocal, 3),
           "low_local": (jf.LowFreqLocal, tf.LowFreqLocal, 7),
           "high_global": (jf.HighFreqGlobal, tf.HighFreqGlobal, None),
           "low_global": (jf.LowFreqGlobal, tf.LowFreqGlobal, None)}


def _expert(kind, rank, k=None):
    jcls, tcls, default = EXPERTS[kind]
    if default is None:
        return jcls(rank), tcls(rank)
    return jcls(rank, k or default), tcls(rank, k or default)


@pytest.mark.parametrize("hw", [(11, 9), (12, 10)])
@pytest.mark.parametrize("kind", sorted(EXPERTS))
def test_experts(kind, hw):
    """Each expert body's output, and its input and parameter gradients,
    at an odd and an even side."""
    rng = np.random.default_rng(1)
    jmod, tmod = _expert(kind, 8)
    x = _x(rng, 8, *hw)
    params = randomized(init_shapes(jmod, x)["params"], rng)
    if "global" in kind:  # the scalars near their inits, not near 0
        params = {k: np.float32(1.0 + 0.3 * rng.standard_normal())
                  for k in params}
    load(tmod, params).eval()
    g = rng.standard_normal(x.shape).astype(np.float32)

    def loss(p, a):
        return jnp.sum(jmod.apply({"params": p}, a) * g)

    want = jmod.apply({"params": params}, x)
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, x)
    xt = nchw(x).requires_grad_(True)
    out = tmod(xt)
    (out * nchw(g)).sum().backward()
    hold(nhwc(out), want)
    hold(nhwc(xt.grad), jgx)
    grads_close(tmod, jgp)


def test_low_local_kernel_sizes():
    rng = np.random.default_rng(2)
    for k in (5, 9):
        jmod, tmod = _expert("low_local", 8, k)
        x = _x(rng, 8)
        params = randomized(init_shapes(jmod, x)["params"], rng)
        load(tmod, params).eval()
        with torch.no_grad():
            hold(nhwc(tmod(nchw(x))), jmod.apply({"params": params}, x))


@pytest.mark.parametrize("kind", sorted(EXPERTS))
def test_mod_expert(kind):
    """FreqModExpert around each body, with a shared branch of another
    width (flax infers it; ``shared_dim`` here)."""
    rng = np.random.default_rng(3)
    jcls, tcls, _ = EXPERTS[kind]
    jmod = jf.FreqModExpert(16, 4, jcls, 5)
    tmod = tf.FreqModExpert(16, 4, tcls, 5, shared_dim=12)
    x, shared = _x(rng, 16), _x(rng, 12, offset=0.0)
    params = randomized(init_shapes(jmod, x, shared)["params"], rng)
    load(tmod, params).eval()
    with torch.no_grad():
        got = tmod(nchw(x), nchw(shared))
    hold(nhwc(got), jmod.apply({"params": params}, x, shared))


@pytest.mark.parametrize("hw", [(8, 12), (9, 7), (16, 16)])
def test_frequency_energy(hw):
    """The (B, 8) histogram at even and odd sides; the farthest pixels of
    the centred grid (one corner at even sides, four at odd) lie in no bin
    (the upper edge is exclusive), as in JAX."""
    rng = np.random.default_rng(4)
    x = _x(rng, 6, *hw, offset=0.0)
    want = jf.frequency_energy(jnp.asarray(x))
    got = tf.frequency_energy(nchw(x))
    assert got.shape == (2, 8)
    hold(got.numpy(), want)
    h, w = hw
    yy, xx = np.mgrid[-(h // 2): h - h // 2, -(w // 2): w - w // 2]
    far = (yy ** 2 + xx ** 2 == (yy ** 2 + xx ** 2).max()).sum()
    masks = tf._energy_masks(h, w, 8, "cpu")
    assert masks.sum() == h * w - far and masks.sum(0).max() == 1


def _router(rng, x, freq_emb):
    jmod = jf.FreqRoutingFunction(16, 32, 4, 2)
    tmod = tf.FreqRoutingFunction(16, 32, 4, 2)
    params = randomized(init_shapes(jmod, x, freq_emb)["params"], rng,
                        scale=1.0)
    load(tmod, params).eval()
    return jmod, tmod, params


@pytest.mark.parametrize("emb", [False, True], ids=["energy", "given"])
def test_routing_eval(emb):
    """Gates, picks and values without noise, from the image's own energy
    histogram or a given embedding; aux 0."""
    rng = np.random.default_rng(5)
    x = _x(rng, 16, b=4, offset=0.0)
    femb = rng.random((4, 8), dtype=np.float32) if emb else None
    jmod, tmod, params = _router(rng, x, femb)
    gates, idx, vals, aux = jmod.apply({"params": params}, x, femb)
    with torch.no_grad():
        tg, ti, tv, taux = tmod(nchw(x), None if femb is None else
                                torch.from_numpy(femb))
        assert kth_gap(tmod.logits(nchw(x), None if femb is None else
                                   torch.from_numpy(femb)), 2) > GAP_MIN
    hold(tg.numpy(), gates)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    hold(tv.numpy(), vals)
    assert taux == 0.0 and aux == 0.0


def test_routing_train_same_noise(same_noise):  # noqa: F811
    """Training: JAX's noise fed to the port (one seeded stream), the
    noisy gates and picks, and the aux loss (importance of the clean
    softmax, load of (logits, logits))."""
    rng = np.random.default_rng(6)
    x = _x(rng, 16, b=4, offset=0.0)
    jmod, tmod, params = _router(rng, x, None)
    with pytest.raises(ValueError, match="Generator"):
        tmod(nchw(x), train=True)
    js, ts = same_noise(61)
    gates, idx, _, aux = jmod.apply({"params": params}, x, train=True,
                                    rngs={"moe": KEY})
    tg, ti, _, taux = tmod(nchw(x), train=True, generator=gen())
    assert js.shapes == ts.shapes == [(4, 4)]
    hold(tg.detach().numpy(), gates)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    np.testing.assert_allclose(taux.item(), float(aux), rtol=1e-5)


def _adapter_pair(rng, x, shared, rank_type="constant"):
    jmod = jf.FreqAdapterLayer(16, 4, rank_type=rank_type, freq_dim=32)
    tmod = tf.FreqAdapterLayer(16, 4, rank_type=rank_type, freq_dim=32)
    femb = rng.random((x.shape[0], 8), dtype=np.float32)
    params = randomized(init_shapes(jmod, x, femb, shared)["params"], rng)
    for k in ("high_pass_gain", "low_pass_decay", "low_pass_gain",
              "high_pass_decay"):
        for e in params.values():
            body = e.get("body", {}) if isinstance(e, dict) else {}
            if k in body:
                body[k] = np.float32(1.0 + 0.3 * rng.standard_normal())
    load(tmod, params).eval()
    return jmod, tmod, params, femb


@pytest.mark.parametrize("rank_type", ["constant", "spread"])
def test_adapter_layer_eval(rank_type):
    """The whole layer in eval: every expert at its kernel size (3, 5, 7,
    9) and rank, the dense combine, the 1x1 out, and input and parameter
    gradients."""
    rng = np.random.default_rng(7)
    x, shared = _x(rng, 16), _x(rng, 16, offset=0.0)
    jmod, tmod, params, femb = _adapter_pair(rng, x, shared, rank_type)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def loss(p, a):
        return jnp.sum(jmod.apply({"params": p}, a, femb, shared)[0] * g)

    want, aux = jmod.apply({"params": params}, x, femb, shared)
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, x)
    xt = nchw(x).requires_grad_(True)
    out, taux = tmod(xt, torch.from_numpy(femb), nchw(shared))
    (out * nchw(g)).sum().backward()
    assert kth_gap(tmod.routing.logits(nchw(x), torch.from_numpy(femb)),
                   2) > GAP_MIN
    hold(nhwc(out), want)
    assert taux == 0.0 and aux == 0.0
    hold(nhwc(xt.grad), jgx)
    grads_close(tmod, jgp)


def test_adapter_layer_train(same_noise):  # noqa: F811
    """The whole layer in training, JAX's noise fed to the port: output,
    aux loss, and the parameter gradients of output . g + aux."""
    rng = np.random.default_rng(8)
    x, shared = _x(rng, 16, b=4), _x(rng, 16, b=4, offset=0.0)
    jmod, tmod, params, femb = _adapter_pair(rng, x, shared)
    g = rng.standard_normal(x.shape).astype(np.float32)
    same_noise(81)

    def loss(p):
        out, aux = jmod.apply({"params": p}, x, femb, shared, train=True,
                              rngs={"moe": KEY})
        return jnp.sum(out * g) + aux, (out, aux)

    (_, (want, aux)), jgp = jax.value_and_grad(loss, has_aux=True)(params)
    same_noise(81)
    out, taux = tmod(nchw(x), torch.from_numpy(femb), nchw(shared),
                     train=True, generator=gen())
    ((out * nchw(g)).sum() + taux).backward()
    hold(nhwc(out), want)
    np.testing.assert_allclose(taux.item(), float(aux), rtol=1e-5)
    grads_close(tmod, jgp)


@pytest.mark.parametrize("kind", ["high_global", "low_global"])
def test_global_experts_zero_coefficients(kind, monkeypatch):
    """A constant channel's non-DC rfft2 coefficients are exactly 0: JAX's
    input gradient is NaN there (sqrt and atan2 at 0), the port's finite
    and equal to the reference formulation's (``torch.abs`` and
    ``torch.angle`` of the complex coefficient, which differentiate to 0
    at 0)."""
    rng = np.random.default_rng(9)
    x = _x(rng, 2, 8, 8, b=1)
    x[..., 0] = 0.75
    jmod, tmod = _expert(kind, 2)
    params = {k: np.float32(1.2) for k in init_shapes(jmod, x)["params"]}
    load(tmod, params)
    jgx = jax.grad(lambda a: jnp.sum(jmod.apply({"params": params}, a)
                                     ** 2))(x)
    assert np.isnan(np.asarray(jgx)).any()

    def grad():
        xt = nchw(x).requires_grad_(True)
        (tmod(xt) ** 2).sum().backward()
        return xt.grad

    got = grad()
    assert torch.isfinite(got).all()

    def reference_polar(re, im):
        z = torch.complex(re, im)
        return torch.abs(z), torch.angle(z)

    monkeypatch.setattr(tf, "_polar", reference_polar)
    hold(got.numpy(), grad().numpy())


def test_cached_tables_serve_a_later_backward():
    """The radial grid and the energy masks are cached per shape; a table
    first built under ``torch.inference_mode`` (serving) still serves a
    later backward at that shape (training)."""
    adapter = tf.FreqAdapterLayer(8, 2, freq_dim=16)
    x = torch.randn(2, 8, 13, 7)
    with torch.inference_mode():
        adapter(x, None, x)
    xt = x.clone().requires_grad_(True)
    out, _ = adapter(xt, None, xt)
    out.sum().backward()
    assert torch.isfinite(xt.grad).all()
