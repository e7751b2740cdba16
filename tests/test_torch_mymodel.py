"""The port's MyModel (``models/mymodel.py``) against the JAX package's, on
the same weights and BatchNorm statistics.

Each JAX module gets seeded variables (``tests/family_parity.py``
``seeded_adaptir``: ``randomized`` parameters, so the zero-initialised
``beta``/``gamma`` layer scales and adapter ``tail``\\ s are random too and
every branch reaches the output; seeded running statistics; integer phase
weights), the trees go into the port through ``state_dict_from_jax`` with
:func:`mymodel_key_map`, and both run the same seeded numpy inputs in fp32
(JAX at "highest" matmul precision, torch with TF32 off); the port takes
NCHW, the JAX package NHWC.

Tolerance (``family_parity.hold``): relative L2 <= 1e-5 and max |error|
<= 1e-5 x max |JAX output|, for every module, the running statistics, the
balance loss and the whole model; every router's top-1/top-2 softmax gap
above 1e-5 (``GAP_MIN``), so no pick can flip between the packages. bf16:
the port's bf16 output against JAX's fp32 within 3x the JAX bf16 model's
error against it (max and mean).

**The phase.** IlluFre and the adapter take the angle of rfft2
coefficients. The modules run on odd-sided maps with a positive DC (the
only real coefficient); the whole model runs at 32x32, where both
packages' rfft2 give the real coefficients an imaginary part of exactly 0
(tests/test_torch_fpn_restormer.py measures the fft2 case).

* IlluFre; GatedDegradationAdaption; MyAdaptIR (with and without biases,
  eval and ``train=True``: output and statistics); Mix at both
  ``ln_type``\\ s; MyEncoderBlock (eval and ``train=True``); MyDecoderBlock
  at batch 1 (the switched top-1 adapter, equal to the dense combine) and
  batch 2.
* The whole model at dim 16, two levels of one block, one decoder block,
  32x32: ``WithBias`` and ``HolisticWithBias`` at batch 1 (the switched
  path); bf16; ``train=True`` at batch 2 (dense) with one noise stream
  fed to both packages (``tests/moe_parity.py`` ``same_noise``): the
  output, the balance loss and the statistics.
* Gradients: the whole model's (eval, batch 2) and IlluFre's against
  ``jax.grad`` (the whole model's input gradient at 1e-4, see its test);
  at zero rfft2 coefficients JAX's IlluFre input gradient is NaN and the
  port's finite, the reference formulation's.
* ``cli/infer.py`` serves it on the CPU; ``cli/train.py`` refuses it with
  the model-level call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    GAP_MIN, bf16_within_three_times, grads_close, hold, init_shapes, load,
    nchw, nhwc, routing_gaps, seeded_adaptir,
)
from moe_parity import (  # noqa: F401  (fixtures, used by name)
    KEY, compiled, gen, same_noise, traced_shapes,
)
from PIL import Image

from image_restoration_tpu.models import mymodel as jm
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import mymodel as tm
from image_restoration_tpu_torch.models.adaptir_ipt import AdaptIRAdapter
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

KEY_MAP = tm.mymodel_key_map


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _x(rng, c, h=11, w=9, b=2, offset=0.0):
    return (rng.standard_normal((b, h, w, c)) + offset).astype(np.float32)


def _port(tmod, v):
    return load(tmod, v["params"], KEY_MAP, v.get("batch_stats")).eval()


def _stats_hold(tmod, v):
    want = state_dict_from_jax(v["params"], tmod.state_dict(), KEY_MAP,
                               jax.tree.map(np.array, v["batch_stats"]))
    n = 0
    for k, t in tmod.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            hold(t.numpy(), want[k].numpy())
            n += 1
    assert n


def _pair(jmod, tmod, rng, *inputs, train=False, bn_bias=None):
    """(JAX output, port output, JAX variables after, port module); with
    ``train`` both run ``train=True``, JAX with ``mutable=
    ["batch_stats"]``. ``bn_bias`` sets every BatchNorm's bias (a positive
    one gives the adapter's rfft2 a positive DC)."""
    v = seeded_adaptir(init_shapes(jmod, *inputs), rng)
    if bn_bias is not None:
        v["params"] = _set_bn_bias(v["params"], bn_bias)
    _port(tmod, v)
    kw = {"train": True} if train else {}
    if train:
        want, new = jmod.apply(v, *inputs, mutable=["batch_stats"], **kw)
        v = {**v, **new}
    else:
        want = jmod.apply(v, *inputs)
    with torch.no_grad():
        got = tmod(*(nchw(a) for a in inputs), **kw)
    return want, got, v, tmod


def _set_bn_bias(tree, value):
    out = {}
    for k, t in tree.items():
        if isinstance(t, dict):
            t = _set_bn_bias(t, value)
            if k == "BN":
                t = dict(t, bias=np.full_like(t["bias"], value))
        out[k] = t
    return out


def test_illu_fre():
    """On an 11x9 map with a positive mean: DC is the only real rfft2
    coefficient, positive, so every angle is unambiguous."""
    rng = np.random.default_rng(0)
    want, got, _, _ = _pair(jm.IlluFre(8, True), tm.IlluFre(8, True), rng,
                            _x(rng, 8, offset=1.0))
    hold(nhwc(got), want)


def test_gated_degradation_adaption():
    rng = np.random.default_rng(1)
    want, got, _, _ = _pair(jm.GatedDegradationAdaption(8),
                            tm.GatedDegradationAdaption(8), rng, _x(rng, 8))
    hold(nhwc(got), want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_adaptir(bias, train):
    rng = np.random.default_rng(2)
    tmod = AdaptIRAdapter(16, 2, 4, bias=bias, tail_bias=bias)
    want, got, v, tmod = _pair(jm.MyAdaptIR(16, 2, bias), tmod, rng,
                               _x(rng, 16), train=train, bn_bias=3.0)
    hold(nhwc(got), want)
    _stats_hold(tmod, v)


@pytest.mark.parametrize("ln_type", ["WithBias", "HolisticWithBias"])
def test_mix(ln_type):
    rng = np.random.default_rng(3)
    want, got, _, _ = _pair(jm.Mix(16, 2, ln_type=ln_type, use_bias=True),
                            tm.Mix(16, 2, ln_type=ln_type, bias=True), rng,
                            _x(rng, 16, offset=1.0))
    hold(nhwc(got), want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_block(train):
    rng = np.random.default_rng(4)
    want, got, v, tmod = _pair(jm.MyEncoderBlock(16, 2),
                               tm.MyEncoderBlock(16, 2), rng,
                               _x(rng, 16, offset=1.0), train=train,
                               bn_bias=3.0)
    hold(nhwc(got), want)
    _stats_hold(tmod, v)


@pytest.mark.parametrize("b", [1, 2], ids=["switched", "dense"])
def test_decoder_block(b):
    """At batch 1 the adapter runs its one picked expert (``switched_eval``,
    as JAX's ``nn.switch``) and equals the dense combine; at batch 2 it
    combines densely."""
    rng = np.random.default_rng(5)
    x, f = _x(rng, 16, 8, 8, b=b), rng.standard_normal((b, 32)).astype(
        np.float32)
    jmod = jm.MyDecoderBlock(16, 2, freq_dim=32)
    v = seeded_adaptir(init_shapes(jmod, x, f), rng)
    want, _ = compiled(lambda var, a, c: jmod.apply(var, a, c), v, x, f)
    outs = []
    for switched in (True, False):
        tmod = _port(tm.MyDecoderBlock(16, 2, freq_dim=32,
                                       switched_eval=switched), v)
        gaps = routing_gaps(tmod)
        with torch.no_grad():
            outs.append(tmod(nchw(x), torch.from_numpy(f)))
        assert min(gaps) > GAP_MIN
    hold(nhwc(outs[0]), want)
    hold(nhwc(outs[1]), nhwc(outs[0]), tol=1e-6)


TINY = dict(dim=16, levels=2, heads=(1, 2), num_blocks=(1, 1),
            num_dec_blocks=(1,), stage_depth=(1,))


@functools.lru_cache(maxsize=None)
def _variables(ln_type="WithBias"):
    """(variables, a seeded (2, 32, 32, 3) batch) of MyModel at ``TINY``."""
    rng = np.random.default_rng(10)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    shapes = traced_shapes(jm.MyModel(**TINY, ln_type=ln_type),
                           jnp.asarray(x))
    return seeded_adaptir(shapes, rng), x


@functools.lru_cache(maxsize=None)
def _jax_model(ln_type="WithBias", bf16=False):
    """(variables, x, JAX output) of MyModel at ``TINY`` on the first
    image of the batch (batch 1: the switched top-1 path), compiled; the
    bf16 model reads the same variables."""
    v, x = _variables(ln_type)
    jnet = jm.MyModel(**TINY, ln_type=ln_type,
                      dtype=jnp.bfloat16 if bf16 else None)
    want = compiled(lambda var, a: jnet.apply(var, a), v, x[:1])
    return v, x[:1], np.asarray(want, np.float32)


def _port_model(v, ln_type="WithBias", dtype=None):
    return _port(get_model("mymodel", **TINY, ln_type=ln_type, dtype=dtype),
                 v)


@pytest.mark.parametrize("ln_type", ["WithBias", "HolisticWithBias"])
def test_whole_model_matches_jax(ln_type):
    v, x, want = _jax_model(ln_type)
    model = _port_model(v, ln_type)
    gaps = routing_gaps(model)
    with torch.inference_mode():
        got = model(nchw(x))
    assert min(gaps) > GAP_MIN and len(gaps) == 1
    assert got.dtype == torch.float32 and got.shape == (1, 3, 32, 32)
    hold(nhwc(got), want)


def test_bf16_within_three_times_jax_bf16():
    v, x, want32 = _jax_model()
    _, _, want16 = _jax_model(bf16=True)
    with torch.inference_mode():
        got = _port_model(v, dtype=torch.bfloat16)(nchw(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    bf16_within_three_times(nhwc(got), want16, want32)


def test_train_forward_matches_jax(same_noise):
    """``model(x, train=True, generator=g)`` at batch 2 against JAX's
    ``train=True`` apply with ``mutable=["batch_stats"]``, the routing
    noise from one stream: the output, ``aux_loss`` and every updated
    BatchNorm statistic."""
    v, x = _variables()
    jnet = jm.MyModel(**TINY)
    js, ts = same_noise(12)
    (want, aux), new = compiled(lambda var, a: jnet.apply(
        var, a, train=True, mutable=["batch_stats"], rngs={"moe": KEY}),
        v, x)
    model = _port_model(v)
    with torch.no_grad():
        got, taux = model(nchw(x), train=True, generator=gen())
    assert js.shapes == ts.shapes and len(ts.shapes) == 1
    assert set(taux) == {"aux_loss"}
    hold(nhwc(got), want)
    hold(taux["aux_loss"].numpy(), aux["aux_loss"])
    _stats_hold(model, {**v, **new})


def test_gradients_match_jax():
    """d(sum(out * g))/d(input, every parameter) of the whole model at
    batch 2 (the dense combine) in eval against ``jax.grad``. The input
    gradient is held at relative L2 1e-4 and max |error| 1e-4 x its
    largest: JAX's own gradient compiled at XLA's full optimisation and
    at ``FAST`` differs by 2.1e-5 relative L2 and 3.1e-5 x its largest
    (this configuration and seed; ``tools/branch_cpu_figures.py``), and
    the port's lies as close to either (1.8e-5 and 2.2e-5 from the first,
    2.2e-5 and 3.9e-5 from the second).
    The parameter gradients: ``grads_close``."""
    v, x = _variables()
    jnet = jm.MyModel(**TINY)
    g = np.random.default_rng(11).standard_normal(x.shape).astype(np.float32)

    def loss(p, a):
        return jnp.sum(jnet.apply({**v, "params": p}, a) * g)

    jgp, jgx = compiled(jax.grad(loss, argnums=(0, 1)), v["params"], x)
    model = _port_model(v)
    xt = nchw(x).requires_grad_(True)
    (model(xt) * nchw(g)).sum().backward()
    hold(nhwc(xt.grad), jgx, tol=1e-4)
    grads_close(model, jgp, KEY_MAP)


def _reference_polar(re, im):
    z = torch.complex(re, im)
    return torch.abs(z), torch.angle(z)


@pytest.mark.parametrize("zeros", [False, True],
                         ids=["positive_dc", "zero_coefficients"])
def test_illu_fre_gradients(zeros, monkeypatch):
    """IlluFre's input and parameter gradients against ``jax.grad`` on an
    11x9 map with a positive mean; with constant channels (every non-DC
    coefficient exactly 0) JAX's input gradient is NaN, the port's finite
    and the reference formulation's (``torch.abs``/``torch.angle``)."""
    rng = np.random.default_rng(13)
    x = _x(rng, 8, offset=1.0)
    if zeros:
        x[..., :4] = 0.5
    g = _x(rng, 8)
    jmod = jm.IlluFre(8, True)
    v = seeded_adaptir(init_shapes(jmod, x), rng)

    def loss(p, a):
        return jnp.sum(jmod.apply({"params": p}, a) * g)

    jgp, jgx = compiled(jax.grad(loss, argnums=(0, 1)), v["params"], x)
    tmod = _port(tm.IlluFre(8, True), v)
    grads = []
    for polar in (tm._polar, _reference_polar):
        monkeypatch.setattr(tm, "_polar", polar)
        xt = nchw(x).requires_grad_(True)
        tmod.zero_grad()
        (tmod(xt) * nchw(g)).sum().backward()
        grads.append(xt.grad)
        if len(grads) == 1 and not zeros:
            grads_close(tmod, jgp, KEY_MAP)
    assert torch.isfinite(grads[0]).all()
    hold(nhwc(grads[0]), nhwc(grads[1]))
    if zeros:
        assert np.isnan(np.asarray(jgx)).any()
    else:
        hold(nhwc(grads[0]), jgx)


def test_infer_serves_on_the_cpu(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    arr = (np.random.default_rng(30).random((37, 45, 3)) * 255).astype(
        np.uint8)
    Image.fromarray(arr).save(str(src / "im.png"))
    sets = [a for k, val in TINY.items()
            for a in ("--set", f"model_kwargs.{k}={val}")]
    outs = infer.main(["--model", "mymodel", "--device", "cpu", "--input",
                       str(src), "--output_dir", str(tmp_path / "out"),
                       *sets])
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(37, 45, 3)]


@pytest.mark.parametrize("name", ["fpn_restormer", "mymodel"])
def test_train_cli_refuses(name, tmp_path):
    """As the JAX ``cli/train.py``, which keeps no ``batch_stats``, the
    training CLI refuses FPN-Restormer and MyModel, naming the model-level
    call."""
    from image_restoration_tpu_torch.cli import train as train_cli

    call = {"fpn_restormer": "model(x, train=True)",
            "mymodel": "model(img, train=True, generator=g)"}[name]
    with pytest.raises(NotImplementedError, match="model level") as err:
        train_cli.main(["--model", name, "--device", "cpu", "--ckpt_dir",
                        str(tmp_path)])
    assert call in str(err.value)
