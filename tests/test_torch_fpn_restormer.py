"""The port's FPN-Restormer (``models/fpn_restormer.py``) against the JAX
package's, on the same weights and BatchNorm statistics.

Each JAX module gets seeded random parameters and running statistics
(``tests/family_parity.py`` ``randomized`` and ``seeded_stats``), the
trees go into the port through ``state_dict_from_jax``, and both run the
same seeded numpy inputs in fp32 (JAX at "highest" matmul precision, torch
with TF32 off); the port takes NCHW, the JAX package NHWC.

Tolerance (``family_parity.hold``): relative L2 <= 1e-5 and max |error|
<= 1e-5 x max |JAX output|, for every module, the running statistics and
the whole model. bf16: the port's bf16 output against JAX's fp32 within 3x
the JAX bf16 model's error against it (max and mean).

**The phase.** FrequencyAwareBlock feeds the angle of fft2 coefficients to
a 1x1 conv. A coefficient that is real for a real input (DC, and the
Nyquist row and column of an even side) has the angle 0 or pi; JAX's CPU
fft2 leaves rounding noise in the imaginary part of the Nyquist ones
when a side is not a power of two (up to 2.5e-6 on a (2, 64, 48, 8) map),
where torch's is exactly 0, so a negative one's angle differs by 2 pi.
Modules that take the angle run on odd-sided maps (only DC is real) with
a positive DC; the whole models run at 32x32, whose maps (32, 16, 8, 4)
have power-of-two sides, where both packages' imaginary parts are
exactly 0 (:func:`test_fft2_real_coefficients`). No proxy of JAX's fft is
needed.

* ECA, DSConv (dilated), GatedMDTA (no gate, headwise, elementwise),
  TransformerBlock, FrequencyAwareBlock and LightFFTDSConvBlock (eval,
  and ``train=True`` against JAX's ``mutable=["batch_stats"]`` apply: the
  output and every updated statistic), UpKeep, DownKeep, FPNFusion,
  PAFPNFusion with and without the task-aware weights.
* The whole model at dim 8 (one block a level, one refinement block) at
  32x32: ``use_frequency_aware=False`` at each fusion type and each gate
  type, the default configuration (PAFPN, no gate, frequency-aware,
  task-aware), and the JAX parity test's three (PAFPN elementwise and
  no fusion frequency-aware, FPN headwise without); the default in bf16
  and with ``train=True`` (output and statistics).
* Gradients: the whole model's (``use_frequency_aware=False``, eval)
  against ``jax.grad``; FrequencyAwareBlock's on an odd-sided map with a
  positive DC (no angle is ambiguous); on a map with zero coefficients
  JAX's input gradient is NaN (sqrt and atan2 at 0) and the port's is the
  reference's (``torch.abs``/``torch.angle``: 0 there), finite.
* ``cli/infer.py`` and ``cli/test.py`` serve and score it on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    bf16_within_three_times, grads_close, hold, init_shapes, load, nchw,
    nhwc, randomized, seeded_stats,
)
from moe_parity import compiled, traced_shapes
from PIL import Image

from image_restoration_tpu.models import fpn_restormer as jf
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli import test as T
from image_restoration_tpu_torch.models import fpn_restormer as tf
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _x(rng, c, h=12, w=10, b=2, offset=0.0):
    return (rng.standard_normal((b, h, w, c)) + offset).astype(np.float32)


def _variables(shapes, rng):
    v = {"params": randomized(shapes["params"], rng)}
    if "batch_stats" in shapes:
        v["batch_stats"] = seeded_stats(shapes["batch_stats"], rng)
    return v


def _port(tmod, v):
    return load(tmod, v["params"], batch_stats=v.get("batch_stats")).eval()


def _pair(jmod, tmod, rng, *inputs, train=False):
    """(JAX output, port output, JAX variables after, port module) on
    shared seeded weights and statistics; with ``train`` both run
    ``train=True``, JAX with ``mutable=["batch_stats"]``."""
    v = _variables(init_shapes(jmod, *inputs), rng)
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


def _stats_hold(tmod, v):
    """The port's running statistics against the JAX ``batch_stats``."""
    want = state_dict_from_jax(v["params"], tmod.state_dict(),
                               batch_stats=jax.tree.map(
                                   np.array, v["batch_stats"]))
    n = 0
    for k, t in tmod.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            hold(t.numpy(), want[k].numpy())
            n += 1
    assert n


def test_fft2_real_coefficients():
    """The imaginary parts of the coefficients that are real for a real
    input: exactly 0 in both packages at power-of-two sides; JAX's carry
    rounding noise at a side of 48, torch's are still exactly 0."""
    rng = np.random.default_rng(0)
    for h, w, noisy in ((32, 32, False), (16, 8, False), (64, 48, True)):
        x = rng.standard_normal((2, h, w, 8)).astype(np.float32)
        zj = np.asarray(jnp.fft.fft2(jnp.asarray(x), axes=(1, 2)))
        zt = torch.fft.fft2(nchw(x)).permute(0, 2, 3, 1).numpy()
        real = [(0, 0), (0, w // 2), (h // 2, 0), (h // 2, w // 2)]
        jim = max(np.abs(zj[:, i, j].imag).max() for i, j in real)
        assert max(np.abs(zt[:, i, j].imag).max() for i, j in real) == 0
        assert (jim > 0) == noisy, (h, w, jim)


def test_eca():
    rng = np.random.default_rng(1)
    want, got, _, _ = _pair(jf.ECA(), tf.ECA(), rng, _x(rng, 8))
    hold(nhwc(got), want)


def test_dsconv():
    rng = np.random.default_rng(2)
    want, got, _, _ = _pair(jf.DSConv(8, 3, 2), tf.DSConv(8, 3, 2), rng,
                            _x(rng, 8))
    hold(nhwc(got), want)


@pytest.mark.parametrize("gate", [None, "headwise", "elementwise"])
def test_gated_mdta(gate):
    rng = np.random.default_rng(3)
    want, got, _, _ = _pair(jf.GatedMDTA(16, 4, gate_type=gate),
                            tf.GatedMDTA(16, 4, gate_type=gate), rng,
                            _x(rng, 16))
    hold(nhwc(got), want)


def test_transformer_block():
    rng = np.random.default_rng(4)
    want, got, _, _ = _pair(jf.TransformerBlock(16, 2, 2.66),
                            tf.TransformerBlock(16, 2, 2.66), rng,
                            _x(rng, 16))
    hold(nhwc(got), want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["frequency_aware", "light"])
def test_encoder_blocks(name, train):
    """On an 11x9 map whose frequency half has a positive mean: its fft2's
    only real coefficient is DC, positive, so every angle is
    unambiguous."""
    rng = np.random.default_rng(5)
    cls = {"frequency_aware": (jf.FrequencyAwareBlock,
                               tf.FrequencyAwareBlock),
           "light": (jf.LightFFTDSConvBlock, tf.LightFFTDSConvBlock)}[name]
    x = _x(rng, 16, 11, 9, offset=1.0)
    want, got, v, tmod = _pair(cls[0](16, dilation=2),
                               cls[1](16, dilation=2), rng, x, train=train)
    hold(nhwc(got), want)
    _stats_hold(tmod, v)


@pytest.mark.parametrize("name", ["up", "down"])
def test_keep_resamplers(name):
    rng = np.random.default_rng(6)
    jmod, tmod = {"up": (jf.UpKeep(16), tf.UpKeep(16)),
                  "down": (jf.DownKeep(16), tf.DownKeep(16))}[name]
    want, got, _, _ = _pair(jmod, tmod, rng, _x(rng, 16))
    hold(nhwc(got), want)


@pytest.mark.parametrize("kind", ["FPN", "PAFPN", "PAFPN_plain"])
def test_fusions(kind):
    rng = np.random.default_rng(7)
    dims = (8, 16, 32, 64)
    feats = [_x(rng, d, 16 // 2 ** i, 24 // 2 ** i) for i, d in
             enumerate(dims)]
    if kind == "FPN":
        jmod, tmod = jf.FPNFusion(dims), tf.FPNFusion(dims)
    else:
        ta = kind == "PAFPN"
        jmod = jf.PAFPNFusion(dims, task_aware=ta)
        tmod = tf.PAFPNFusion(dims, task_aware=ta)
    v = _variables(init_shapes(jmod, feats), rng)
    want = jmod.apply(v, feats)
    with torch.no_grad():
        got = _port(tmod, v)([nchw(f) for f in feats])
    for g, w in zip(got, want):
        hold(nhwc(g), w)


TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
# (fusion_type, gate_type, use_frequency_aware): each fusion type and
# each gate type without the frequency-aware blocks, the default, and the
# JAX parity test's three (tests/test_fpn_restormer_parity.py)
CONFIGS = [("None", None, False), ("FPN", "headwise", False),
           ("PAFPN", "elementwise", False), ("PAFPN", None, True),
           ("PAFPN", "elementwise", True), ("None", None, True)]
DEFAULT = ("PAFPN", None, True)


def _kw(config):
    fusion, gate, freq = config
    return dict(TINY, fusion_type=fusion, gate_type=gate,
                use_frequency_aware=freq)


@functools.lru_cache(maxsize=None)
def _jax_model(config, bf16=False, train=False):
    """(variables, x, JAX output[, JAX variables after]) of FPN-Restormer
    at ``TINY`` and ``config`` on a seeded (2, 32, 32, 3) batch, compiled;
    the bf16 model draws the same weights and statistics."""
    rng = np.random.default_rng(10)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    jnet = jf.FPNRestormer(**_kw(config),
                           dtype=jnp.bfloat16 if bf16 else None)
    v = _jax_model(config)[0] if (bf16 or train) else _variables(
        traced_shapes(jf.FPNRestormer(**_kw(config)), jnp.asarray(x)), rng)
    if train:
        out, new = compiled(lambda var, a: jnet.apply(
            var, a, train=True, mutable=["batch_stats"]), v, x)
        return v, x, np.asarray(out), {**v, **new}
    out = compiled(lambda var, a: jnet.apply(var, a), v, x)
    return v, x, np.asarray(out, np.float32)


def _port_model(v, config, dtype=None):
    return _port(get_model("fpn_restormer", **_kw(config), dtype=dtype), v)


@pytest.mark.parametrize("config", CONFIGS,
                         ids=["-".join(map(str, c)) for c in CONFIGS])
def test_whole_model_matches_jax(config):
    v, x, want = _jax_model(config)
    with torch.inference_mode():
        got = _port_model(v, config)(nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32, 32)
    hold(nhwc(got), want)


def test_bf16_within_three_times_jax_bf16():
    v, x, want32 = _jax_model(DEFAULT)
    _, _, want16 = _jax_model(DEFAULT, bf16=True)
    with torch.inference_mode():
        got = _port_model(v, DEFAULT, torch.bfloat16)(nchw(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    bf16_within_three_times(nhwc(got), want16, want32)


def test_train_forward_matches_jax():
    """``forward(x, train=True)`` of the default model: the output and
    every BatchNorm's updated statistics against JAX's ``train=True``
    apply with ``mutable=["batch_stats"]``."""
    v, x, want, new = _jax_model(DEFAULT, train=True)
    model = _port_model(v, DEFAULT)
    with torch.no_grad():
        got = model(nchw(x), train=True)
    hold(nhwc(got), want)
    _stats_hold(model, new)


def test_gradients_match_jax():
    """d(sum(out * g))/d(input, every parameter) of the whole model
    (``use_frequency_aware=False``: no angle) in eval against
    ``jax.grad``."""
    config = CONFIGS[2]
    v, x, _ = _jax_model(config)
    jnet = jf.FPNRestormer(**_kw(config))
    g = np.random.default_rng(11).standard_normal(x.shape).astype(np.float32)

    def loss(p, a):
        return jnp.sum(jnet.apply({**v, "params": p}, a) * g)

    jgp, jgx = compiled(jax.grad(loss, argnums=(0, 1)), v["params"], x)
    model = _port_model(v, config)
    xt = nchw(x).requires_grad_(True)
    (model(xt) * nchw(g)).sum().backward()
    hold(nhwc(xt.grad), jgx)
    grads_close(model, jgp)


def _grads(tmod, x, g):
    xt = nchw(x).requires_grad_(True)
    tmod.zero_grad()
    (tmod(xt) * nchw(g)).sum().backward()
    return xt.grad, [p.grad.clone() for p in tmod.parameters()]


@pytest.mark.parametrize("zeros", [False, True],
                         ids=["positive_dc", "zero_coefficients"])
def test_frequency_aware_gradients(zeros, monkeypatch):
    """FrequencyAwareBlock's input and parameter gradients against
    ``jax.grad`` on an 11x9 map whose frequency half has a positive mean
    (every angle unambiguous); with that half constant, its non-DC
    coefficients are exactly 0: JAX's input gradient is NaN there, the
    port's finite and equal to the reference formulation's (the complex
    ``torch.abs`` and ``torch.angle``)."""
    rng = np.random.default_rng(12)
    x = _x(rng, 16, 11, 9, offset=1.0)
    if zeros:
        x[..., 8:] = 0.75
    g = _x(rng, 16, 11, 9)
    jmod = jf.FrequencyAwareBlock(16, dilation=2)
    v = _variables(init_shapes(jmod, x), rng)

    def loss(p, a):
        return jnp.sum(jmod.apply({**v, "params": p}, a) * g)

    jgp, jgx = compiled(jax.grad(loss, argnums=(0, 1)), v["params"], x)
    tmod = _port(tf.FrequencyAwareBlock(16, dilation=2), v)
    gx, gp = _grads(tmod, x, g)
    assert torch.isfinite(gx).all()
    if zeros:
        assert np.isnan(np.asarray(jgx)).any()
    else:
        hold(nhwc(gx), jgx)
        grads_close(tmod, jgp)
    monkeypatch.setattr(tf, "_polar", _reference_polar)
    rx, rp = _grads(tmod, x, g)
    hold(nhwc(gx), nhwc(rx))
    for a, b in zip(gp, rp):
        hold(a.numpy(), b.numpy())


def _reference_polar(re, im):
    """The reference's magnitude and phase: ``torch.abs`` and
    ``torch.angle`` of the complex coefficient."""
    z = torch.complex(re, im)
    return torch.abs(z), torch.angle(z)


def test_clis_serve_and_score(tmp_path):
    """``cli/infer.py`` restores a 37x45 image (padded to 40x48) and
    ``cli/test.py`` scores a two-image deraining set, both at ``TINY``
    on the CPU: the input's size, finite scores."""
    rng = np.random.default_rng(20)
    src = tmp_path / "in"
    src.mkdir()
    Image.fromarray((rng.random((37, 45, 3)) * 255).astype(np.uint8)).save(
        str(src / "a.png"))
    sets = [a for k, v in TINY.items()
            for a in ("--set", f"model_kwargs.{k}={v}")]
    outs = infer.main(["--model", "fpn_restormer", "--device", "cpu",
                       "--input", str(src), "--output_dir",
                       str(tmp_path / "out"), *sets])
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(37, 45, 3)]
    for sub in ("input", "target"):
        d = tmp_path / "data" / "deraining" / "Rain100L" / sub
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray((rng.random((30, 34, 3)) * 255).astype(
                np.uint8)).save(str(d / f"{i}.png"))
    res = T.main(["--model", "fpn_restormer", "--device", "cpu",
                  "--benchmarks", "derain", "--data_file_dir",
                  str(tmp_path / "data"), "--output_dir",
                  str(tmp_path / "res"), *sets])
    assert np.isfinite(res["derain"]["psnr"]) and np.isfinite(
        res["derain"]["ssim"])
