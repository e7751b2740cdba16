"""The port's SFSNiD, HiLo and PINN (``models/demo_models.py``) against the
JAX package's, on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``
``randomized``), the tree goes into the port through
``state_dict_from_jax`` (SFSNiD's through ``sfsnid_key_map``), and both
run the same seeded numpy inputs in fp32 (JAX at "highest" matmul
precision, torch with TF32 off); the port takes NCHW, JAX NHWC.

Tolerance (``family_parity.hold``): relative L2 <= 1e-5 and max |error|
<= 1e-5 x max |JAX output|, for every module, the whole models and their
gradients. bf16: the port's bf16 output against JAX's fp32 within 3x the
JAX bf16 model's error against it (max and mean). SFSNiD's whole-model
gradient, and its forward at full width, are ill-conditioned in fp32 in
both packages (the angle's branch cut, below): they are held at 1e-5 with
both packages wholly in float64 (``tests/sfsnid_conditioning.py``), and
the port's fp32 to 2x JAX fp32's distance from that float64 result.

**SE width.** SFSNiD's SE layers have ``channel // 16`` hidden units, 0
below 16 channels (the port's gate is then a constant 0.5; flax cannot
build such a layer); the models here run at ``base_channel`` 16 so that
every SE has a unit.

**The phase.** SFSNiD feeds the angle of rfft2 coefficients to a 1x1
conv. A coefficient that is real for a real input (DC, and the Nyquist row
and column of an even side) has the angle 0 or +-pi; at sides that are not
powers of two either package's FFT can leave ~1e-6 of rounding noise in
its imaginary part (:func:`test_self_conjugate_noise`), and a negative
one's angle then differs by 2 pi between the packages. Modules that take
the angle run on odd-sided maps with a positive DC or on power-of-two
sides; the whole model runs at 32x32 as it is, and at 40x24 (maps 40x24,
20x12, 10x6, window pads of 4, 6 and 2) with both packages' rfft2 made
exact at those coefficients (:func:`exact_self_conjugate`: their
imaginary parts set to 0 on both sides), so that what is compared is the
model and not the FFT libraries' rounding. Any coefficient whose
imaginary part is within rounding of 0 while its real part is negative
sits on the angle's branch cut in the same way, and a deep stack has
many: two fp32 runs then part, which is why the whole model's fp32
gradient, and its fp32 forward at full width, are held to JAX's own fp32
distance from float64 instead.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    bf16_within_three_times, grads_close, hold, init_shapes, load, nchw,
    nhwc, randomized, train_step_pair,
)
from moe_parity import compiled, traced_shapes
from PIL import Image
from sfsnid_conditioning import forward_readings, gradient_readings, rel

from image_restoration_tpu.cli.infer import make_restore_fn as jax_restore_fn
from image_restoration_tpu.models import demo_models as jd
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli import test as T
from image_restoration_tpu_torch.cli import train as train_cli
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.models import demo_models as td
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.ops.common import reflect_pad
from image_restoration_tpu_torch.utils.options import parse_options

KM = td.sfsnid_key_map


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _x(rng, c, h=11, w=9, b=2, offset=1.0):
    return (rng.standard_normal((b, h, w, c)) + offset).astype(np.float32)


def _pair(jmod, tmod, rng, *inputs, to_torch=nchw, key_map=KM):
    """(JAX output, port output) on shared seeded weights."""
    params = randomized(init_shapes(jmod, *inputs)["params"], rng)
    load(tmod, params, key_map).eval()
    want = jmod.apply({"params": params}, *inputs)
    with torch.no_grad():
        got = tmod(*(to_torch(a) for a in inputs))
    return want, got


def _self_conjugate(h, w):
    """(H, W // 2 + 1) mask of the rfft2 coefficients that are real for a
    real input."""
    rows = np.zeros(h, bool)
    rows[[0, h // 2]] = [True, h % 2 == 0]
    cols = np.zeros(w // 2 + 1, bool)
    cols[[0, w // 2]] = [True, w % 2 == 0]
    return rows[:, None] & cols[None, :]


class _ExactFft:
    """``jnp.fft`` whose ``rfft2`` sets the imaginary part of the
    self-conjugate coefficients to 0; every other name is ``jnp.fft``'s."""

    def __getattr__(self, name):
        return getattr(jnp.fft, name)

    @staticmethod
    def rfft2(a, *args, axes=(-2, -1), **kw):
        z = jnp.fft.rfft2(a, *args, axes=axes, **kw)
        m = _self_conjugate(a.shape[axes[0]], a.shape[axes[1]])
        shape = [1] * z.ndim
        shape[axes[0]], shape[axes[1]] = m.shape
        return jnp.where(jnp.asarray(m.reshape(shape)), z.real + 0j, z)


class _ExactJnp:
    fft = _ExactFft()

    def __getattr__(self, name):
        return getattr(jnp, name)


def _exact_port_rfft2(x, norm="backward"):
    z = torch.fft.rfft2(x.float(), norm=norm)
    m = torch.from_numpy(_self_conjugate(*x.shape[-2:]))
    return torch.where(m, torch.complex(z.real, torch.zeros_like(z.real)), z)


@contextlib.contextmanager
def exact_self_conjugate(monkeypatch):
    """Both packages' SFSNiD rfft2 with the self-conjugate coefficients'
    imaginary parts exactly 0 (the JAX module's ``jnp`` and the port
    module's ``rfft2`` replaced for the test's duration)."""
    monkeypatch.setattr(jd, "jnp", _ExactJnp())
    monkeypatch.setattr(td, "rfft2", _exact_port_rfft2)
    yield


def test_self_conjugate_noise():
    """The imaginary parts of the self-conjugate rfft2 coefficients: 0 in
    both packages at 32x32; JAX's carry rounding noise at 40x24 and
    torch's at 24x40 (so neither package is exact in general)."""
    rng = np.random.default_rng(0)
    for (h, w), noisy in (((32, 32), ""), ((40, 24), "jax"),
                          ((24, 40), "torch")):
        x = (rng.standard_normal((2, h, w, 16)) + 1).astype(np.float32)
        m = _self_conjugate(h, w)
        zj = np.asarray(jnp.fft.rfft2(jnp.asarray(x), axes=(1, 2)))
        zt = torch.fft.rfft2(nchw(x)).permute(0, 2, 3, 1).numpy()
        im = {"jax": np.abs(zj[:, m].imag).max(),
              "torch": np.abs(zt[:, m].imag).max()}
        if noisy:
            assert im[noisy] > 0, (h, w, im)
        else:
            assert im == {"jax": 0, "torch": 0}, im


@pytest.mark.parametrize("side", [1, 2, 3, 5])
def test_reflect_pad_two_sided(side):
    """``ops/common.py`` ``reflect_pad`` equals ``jnp.pad(mode="reflect")``
    for pads before and after, up to several times the side (periodic
    reflection)."""
    rng = np.random.default_rng(side)
    x = rng.standard_normal((1, 2, side, side + 1)).astype(np.float32)
    for pads in ((0, 6, 0, 6), (2, 2, 2, 2), (3, 7, 5, 1), (9, 0, 0, 11)):
        left, right, top, bottom = pads
        want = np.pad(x, ((0, 0), (0, 0), (top, bottom), (left, right)),
                      mode="reflect")
        got = reflect_pad(torch.from_numpy(x), pads).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jnp.pad(
            x, ((0, 0), (0, 0), (top, bottom), (left, right)),
            mode="reflect")))


@pytest.mark.parametrize("c", [8, 32])
def test_se_layer(c):
    """SE at 32 channels (2 hidden units) against JAX's; at 8 it has no
    unit: the port's gate is a constant 0.5, and flax cannot build the
    layer (its initializer divides by the zero fan-out, in ``init`` and in
    ``apply``'s shape check)."""
    rng = np.random.default_rng(1)
    x = _x(rng, c)
    if c < 16:
        with torch.no_grad():
            hold(nhwc(td.SELayer(c)(nchw(x))), 0.5 * x)
        with pytest.raises(ZeroDivisionError):
            jd.SELayer(c).init(jax.random.PRNGKey(0), x)
        return
    want, got = _pair(jd.SELayer(c), td.SELayer(c), rng, x)
    hold(nhwc(got), want)


def test_freq_spectrum_se():
    """On the rfft2 of an 11x9 map with a positive mean (only DC is real,
    and positive)."""
    rng = np.random.default_rng(2)
    zx = np.fft.rfft2(_x(rng, 16), axes=(1, 2)).astype(np.complex64)
    want, got = _pair(jd.FreqSpectrumSE(16), td.FreqSpectrumSE(16), rng, zx,
                      to_torch=lambda z: torch.from_numpy(
                          np.ascontiguousarray(z.transpose(0, 3, 1, 2))))
    got = got.permute(0, 2, 3, 1).numpy()
    hold(got.real, np.asarray(want).real)
    hold(got.imag, np.asarray(want).imag)


@pytest.mark.parametrize("hw", [(11, 9), (16, 16)])
def test_freq_path(hw):
    rng = np.random.default_rng(3)
    want, got = _pair(jd.FreqPath(16), td.FreqPath(16), rng,
                      _x(rng, 16, *hw))
    hold(nhwc(got), want)


@pytest.mark.parametrize("kind", ["conv", "stride2", "transpose", "linear"])
def test_basic_conv(kind):
    rng = np.random.default_rng(4)
    kw = {"conv": dict(), "stride2": dict(stride=2),
          "transpose": dict(kernel_size=4, stride=2, transpose=True),
          "linear": dict(relu=False)}[kind]
    x = _x(rng, 16, 8, 6)
    want, got = _pair(jd.BasicConv(24, **kw), td.BasicConv(16, 24, **kw),
                      rng, x)
    hold(nhwc(got), want)


def test_res_block_conv():
    rng = np.random.default_rng(5)
    want, got = _pair(jd.ResBlockConv(16), td.ResBlockConv(16), rng,
                      _x(rng, 16))
    hold(nhwc(got), want)


def test_window_attention_crpb():
    rng = np.random.default_rng(6)
    tokens = rng.standard_normal((6, 16, 48)).astype(np.float32)
    want, got = _pair(jd.WindowAttentionCRPB(16, 4, 2),
                      td.WindowAttentionCRPB(16, 4, 2), rng, tokens,
                      to_torch=torch.from_numpy)
    hold(got.numpy(), want)


@pytest.mark.parametrize("hw", [(2, 2), (5, 3), (11, 9), (16, 16)])
@pytest.mark.parametrize("window,shift", [(8, 0), (4, 2)],
                         ids=["w8", "w4s2"])
def test_sfs_attention(hw, window, shift):
    """Window attention at a 2x2 map (a window pad of 6, a depthwise pad
    of 2: both wider than the side), at odd sides and at a whole number of
    windows; unshifted at window 8 (SFSNiD's) and shifted by 2 at 4."""
    rng = np.random.default_rng(7)
    want, got = _pair(jd.SFSAttention(16, 2, window, shift),
                      td.SFSAttention(16, 2, window, shift), rng,
                      _x(rng, 16, *hw))
    hold(nhwc(got), want)


@pytest.mark.parametrize("hw", [(2, 2), (11, 9)])
def test_transformer_block(hw):
    rng = np.random.default_rng(8)
    want, got = _pair(jd.SFSTransformerBlock(16),
                      td.SFSTransformerBlock(16), rng, _x(rng, 16, *hw))
    hold(nhwc(got), want)


@pytest.mark.parametrize("name", ["instance_norm", "scm", "scm_norm",
                                  "conv_out"])
def test_stems_and_heads(name):
    rng = np.random.default_rng(9)
    jmod, tmod, c = {
        "instance_norm": (jd.InstanceNorm(), td.InstanceNorm(16), 16),
        "scm": (jd.SCM(16, False), td.SCM(16, False), 3),
        "scm_norm": (jd.SCM(32, True), td.SCM(32, True), 3),
        "conv_out": (jd.ConvOut(16), td.ConvOut(16), 16)}[name]
    want, got = _pair(jmod, tmod, rng, _x(rng, c, offset=0.3))
    hold(nhwc(got), want)


TINY = dict(num_res=1, base_channel=16)


@functools.lru_cache(maxsize=None)
def _jax_sfsnid(hw=(32, 32), bf16=False, train=True):
    """(params, x, JAX outputs) of SFSNiD at ``TINY`` on a seeded
    (2, H, W, 3) batch, compiled; bf16 draws the same weights."""
    rng = np.random.default_rng(10 + hw[1])
    x = rng.random((2, *hw, 3), dtype=np.float32)
    jnet = jd.SFSNiD(**TINY, dtype=jnp.bfloat16 if bf16 else None)
    params = (_jax_sfsnid(hw)[0] if bf16 else randomized(
        traced_shapes(jd.SFSNiD(**TINY), jnp.asarray(x))["params"], rng))
    out = compiled(lambda p, a: jnet.apply({"params": p}, a, train=train),
                   params, x)
    return params, x, jax.tree.map(lambda o: np.asarray(o, np.float32), out)


def _port_sfsnid(params, dtype=None):
    return load(get_model("sfsnid", **TINY, dtype=dtype), params, KM).eval()


def test_sfsnid_train_outputs_match_jax():
    """``train=True``'s three outputs (1/4, 1/2, full) at 32x32, and
    ``train=False``'s output, the full-size one."""
    params, x, want = _jax_sfsnid()
    model = _port_sfsnid(params)
    with torch.inference_mode():
        got = model(nchw(x), train=True)
        full = model(nchw(x))
    assert [tuple(g.shape) for g in got] == [(2, 3, 8, 8), (2, 3, 16, 16),
                                             (2, 3, 32, 32)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        hold(nhwc(g), w)
    assert torch.equal(full, got[2])


def test_sfsnid_eval_at_40x24(monkeypatch):
    """``train=False`` at 40x24 (window pads at every scale below full),
    both rfft2s exact at the self-conjugate coefficients."""
    with exact_self_conjugate(monkeypatch):
        params, x, want = _jax_sfsnid((40, 24), train=False)
        with torch.inference_mode():
            got = _port_sfsnid(params)(nchw(x))
    assert got.shape == (2, 3, 40, 24)
    hold(nhwc(got), want)


def test_sfsnid_bf16_within_three_times_jax_bf16():
    params, x, want32 = _jax_sfsnid(train=False)
    _, _, want16 = _jax_sfsnid(bf16=True, train=False)
    with torch.inference_mode():
        got = _port_sfsnid(params, torch.bfloat16)(nchw(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    bf16_within_three_times(nhwc(got), want16, want32)


def _module_grads(jmod, tmod, x, rng):
    """(JAX input gradient, parameter gradients; the port's module, after
    its backward) of sum(out * g) on shared seeded weights."""
    params = randomized(init_shapes(jmod, x)["params"], rng)
    g = rng.standard_normal(np.shape(jmod.apply({"params": params}, x)))

    def loss(p, a):
        return jnp.sum(jmod.apply({"params": p}, a) * g)

    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, x)
    load(tmod, params, KM).eval()
    xt = nchw(x).requires_grad_(True)
    (tmod(xt) * nchw(g.astype(np.float32))).sum().backward()
    hold(nhwc(xt.grad), jgx)
    grads_close(tmod, jgp, KM)


@pytest.mark.parametrize("name", ["freq_path", "attention", "block",
                                  "scm_norm", "transpose"])
def test_sfsnid_module_gradients(name):
    """Input and parameter gradients of SFSNiD's modules against
    ``jax.grad``: the phase branch on an odd-sided map with a positive DC,
    the windowed attention at a pad of 6 (3x5 map), the whole block, the
    instance-normed stem, the transposed conv."""
    rng = np.random.default_rng(15)
    jmod, tmod, x = {
        "freq_path": (jd.FreqPath(16), td.FreqPath(16), _x(rng, 16)),
        "attention": (jd.SFSAttention(16, 2), td.SFSAttention(16, 2),
                      _x(rng, 16, 3, 5)),
        "block": (jd.SFSTransformerBlock(16), td.SFSTransformerBlock(16),
                  _x(rng, 16, 9, 7)),
        "scm_norm": (jd.SCM(32, True), td.SCM(32, True), _x(rng, 3, 8, 8)),
        "transpose": (jd.BasicConv(16, 4, 2, transpose=True),
                      td.BasicConv(32, 16, 4, 2, transpose=True),
                      _x(rng, 32, 8, 8))}[name]
    _module_grads(jmod, tmod, x, rng)


def test_sfsnid_gradients_match_jax():
    """d(sum(full output * g))/d(input, every parameter) of the whole
    model at 32x32, on ``randomized``'s weights, against ``jax.grad``.

    Both packages also take it wholly in float64
    (``tests/sfsnid_conditioning.py`` ``gradient_readings``), where the
    port's gradient holds to JAX's at 1e-5 (3.5e-9 relative L2 measured):
    the port differentiates the same function. In fp32 the whole model's
    gradient is ill-conditioned: JAX's own fp32 gradient lies 7.65e-3
    from the float64 one (relative L2, the input's and every parameter's
    concatenated), the port's 7.62e-3 (1.6e-4 from JAX's fp32 one with
    torch on eight threads), while each module holds to 1e-5 in fp32
    (:func:`test_sfsnid_module_gradients`). How far the two fp32 gradients
    lie from each other depends on the rounding of each run (with torch on
    one thread, as in the suite's xdist workers, 7.55e-3), so in fp32
    the port's gradient is held to be no further from the float64 one
    than 2x JAX's fp32 gradient is."""
    grads = gradient_readings()
    hold(grads["port64"], grads["jax64"])
    port, want32, want64 = grads["port32"], grads["jax32"], grads["jax64"]
    assert rel(port, want64) <= 2 * rel(want32, want64), (
        rel(port, want64), rel(want32, want64))


def test_sfsnid_full_width_matches_jax_in_float64():
    """SFSNiD at ``MODEL_DEFAULTS`` (num_res 3, base 32) on 64x64, the
    port's seed-0 init carried into JAX (chip_smoke.py phase 3q's model
    and input; ``tests/sfsnid_conditioning.py``): wholly in float64 the
    two outputs hold at 1e-5 (8.1e-14 relative L2 measured). In fp32 the
    forward is ill-conditioned at this init: JAX's fp32 output lies 0.239
    from the float64 one and the port's 0.054, so the port's fp32 output
    is held to be no further from the float64 one than 2x JAX's is."""
    got = forward_readings(moves=False)
    assert got["port float64 against JAX float64"] <= 1e-5, got
    assert (got["port fp32 against port float64"]
            <= 2 * got["JAX fp32 against JAX float64"]), got


@pytest.mark.parametrize("window,alpha", [(2, 0.5), (2, 0.0), (1, 0.5),
                                          (1, 0.0)])
def test_hilo(window, alpha):
    """HiLo at dim 16 (4 heads) on a 12x10 map of 16 channels (a LITv2
    stage's), and of 3 (the JAX CLIs' init) through ``in_dim``."""
    rng = np.random.default_rng(12)
    for c in (16, 3):
        x = _x(rng, c, 12, 10, offset=0.0)
        want, got = _pair(jd.HiLo(16, 4, window, alpha),
                          td.HiLo(16, 4, window, alpha, in_dim=c), rng, x,
                          key_map=None)
        assert got.shape == (2, 16, 12, 10)
        hold(nhwc(got), want)


def test_hilo_refusals():
    """A side that is not a multiple of the window raises a ValueError
    that names it (JAX's reshape fails there); JAX parameters of another
    input width do not load."""
    with pytest.raises(ValueError, match="window_size 2"):
        td.HiLo(16, 4)(torch.zeros(1, 16, 12, 9))
    x = np.zeros((1, 4, 4, 3), np.float32)
    params = randomized(init_shapes(jd.HiLo(16, 4), x)["params"],
                        np.random.default_rng(0))
    with pytest.raises(ValueError, match="shape mismatch"):
        load(td.HiLo(16, 4), params)


@functools.lru_cache(maxsize=None)
def _jax_pinn(bf16=False):
    rng = np.random.default_rng(13)
    x = rng.random((2, 24, 20, 3), dtype=np.float32)
    jnet = jd.PINNRestoration(dtype=jnp.bfloat16 if bf16 else None)
    params = (_jax_pinn()[0] if bf16 else randomized(
        init_shapes(jd.PINNRestoration(), x)["params"], rng))
    out = compiled(lambda p, a: jnet.apply({"params": p}, a), params, x)
    return params, x, np.asarray(out, np.float32)


def test_pinn_matches_jax():
    params, x, want = _jax_pinn()
    _, _, want16 = _jax_pinn(bf16=True)
    with torch.inference_mode():
        got = load(get_model("pinn"), params).eval()(nchw(x))
        got16 = load(get_model("pinn", dtype=torch.bfloat16),
                     params).eval()(nchw(x))
    assert got.dtype == got16.dtype == torch.float32
    hold(nhwc(got), want)
    bf16_within_three_times(nhwc(got16), want16, want)


def test_pinn_train_step_matches_jax():
    """One step of each package's ``make_train_step`` on PINN with the
    reference's loss, MSE plus the gradient-smoothness prior, each weighted
    1: the logged terms, every gradient and the updated parameters."""
    params, x, _ = _jax_pinn()
    rng = np.random.default_rng(14)
    batch = {"lq": x, "gt": rng.random(x.shape, dtype=np.float32)}
    tnet = load(get_model("pinn"), params)
    logs = train_step_pair(jd.PINNRestoration(), tnet, params, batch,
                           "default",
                           loss={"mse": 1.0, "grad_smooth": 1.0})
    assert {"mse", "grad_smooth"} <= set(logs) and np.isfinite(
        float(logs["total"]))


@pytest.mark.parametrize("name", ["sfsnid", "pinn"])
def test_infer_matches_jax_restore_fn(name, tmp_path):
    """A 29x27 image through the port's ``make_restore_fn`` from the
    ``cli/infer.py`` options (reflect-padded to 32x32 at the default
    ``pad_multiple`` 8) and a JAX ``.npz``, against the JAX CLI's
    ``make_restore_fn`` with the same parameters; then ``main`` writes
    it. The restores clip to [0, 1], so the max |error| is held to 1e-5 x
    the largest |output| of the unclipped padded forward."""
    if name == "sfsnid":
        params, kw, sets = _jax_sfsnid()[0], TINY, [
            a for k, v in TINY.items()
            for a in ("--set", f"model_kwargs.{k}={v}")]
        jnet = jd.SFSNiD(**TINY)
    else:
        params, kw, sets, jnet = _jax_pinn()[0], {}, [], jd.PINNRestoration()
    img = np.random.default_rng(20).random((29, 27, 3), dtype=np.float32)
    npz = str(tmp_path / f"{name}.npz")
    save_params_npz(npz, params)
    argv = ["--model", name, "--fp32", "--device", "cpu", "--ckpt", npz,
            *sets]
    cfg = parse_options(argv)
    assert cfg["pad_multiple"] == 8 and cfg["model_kwargs"] == kw
    want = jax_restore_fn({"model": name, "pad_multiple": 8}, jnet,
                          params)(img)
    model = load_params(cfg, build_model(cfg))
    got = infer.make_restore_fn(cfg, model)(img)
    assert got.shape == img.shape
    with torch.inference_mode():
        padded = reflect_pad(torch.from_numpy(img).permute(2, 0, 1)[None],
                             (0, 5, 0, 3))
        scale = model(padded).abs().max().item()
    hold(got, want, scale=scale)
    src = tmp_path / "in"
    src.mkdir()
    Image.fromarray((img * 255).astype(np.uint8)).save(str(src / "a.png"))
    outs = infer.main(argv + ["--input", str(src), "--output_dir",
                              str(tmp_path / "out")])
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(29, 27, 3)]


def test_build_model_builds_the_three():
    """``cli/train.py`` ``build_model`` builds each new name from its
    ``MODEL_DEFAULTS`` (SFSNiD at num_res 3, base 32; HiLo at dim 96;
    PINN)."""
    want = {"sfsnid": td.SFSNiD, "hilo": td.HiLo, "pinn": td.PINNRestoration}
    for name, cls in want.items():
        model = build_model(parse_options(["--model", name, "--device",
                                           "cpu"]))
        assert type(model) is cls and not model.training
    assert model.encoder[0].compute_dtype == torch.bfloat16


def _aio_tree(root, rng):
    def save(rel, arr):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(arr.astype(np.uint8)).save(str(path))

    for i in range(2):
        clean = rng.random((40, 44, 3)) * 255
        noisy = np.clip(clean + rng.integers(-30, 30, clean.shape), 0, 255)
        save(f"denoising/{i}.png", clean)
        save(f"deraining/RainTrainL/gt/norain-{i}.png", clean)
        save(f"deraining/RainTrainL/rainy/norain-{i}.png", noisy)
        save(f"dehazing/RESIDE/clear/{i}.png", clean)
        save(f"dehazing/RESIDE/part1/{i}_0.8_0.1.png", clean * 0.7 + 50)


@pytest.mark.parametrize("name", ["sfsnid", "pinn"])
def test_trains_through_cli(name, tmp_path):
    """Two steps of ``cli/train.py`` ``main`` on a seeded AIO tree (batch
    2 of 32x32 patches, fp32, the CPU): SFSNiD at ``TINY`` with the
    default recipe (L1 of the full-size output, ``train=False`` as the JAX
    CLI applies it), PINN with MSE plus the gradient-smoothness prior;
    finite logged losses and a checkpoint that loads."""
    import json

    _aio_tree(tmp_path / "data", np.random.default_rng(30))
    extra = ([a for k, v in TINY.items()
              for a in ("--set", f"model_kwargs.{k}={v}")]
             if name == "sfsnid" else ["--loss", "mse=1.0",
                                       "grad_smooth=1.0"])
    state = train_cli.main(
        ["--model", name, "--device", "cpu", "--fp32", "--data_file_dir",
         str(tmp_path / "data"), "--patch_size", "32", "--batch_size", "2",
         "--warmup_epochs", "0", "--ckpt_dir", str(tmp_path / "exp"),
         "--name", "r", "--save_every", "2", "--log_every", "1",
         "--num_workers", "2", *extra], max_steps_override=2)
    assert state.step == 2
    logged = [json.loads(line) for line in open(tmp_path / "exp" / "r" /
                                                "metrics.jsonl")]
    rows = [e for e in logged if "train/total" in e]
    assert [np.isfinite(e["train/total"]) for e in rows] == [True, True]
    if name == "pinn":
        assert {"train/mse", "train/grad_smooth"} <= set(rows[0])
    saved = torch.load(str(tmp_path / "exp" / "r" / "ckpt" / "2.pth"))
    get_model(name, **(TINY if name == "sfsnid" else {})).load_state_dict(
        saved["params"])


@pytest.mark.parametrize("cli", ["infer", "test", "train"])
def test_clis_refuse_hilo(cli, tmp_path):
    """HiLo is an attention layer: every CLI refuses it with a message that
    names the model-level call."""
    argv = ["--model", "hilo", "--device", "cpu", "--input", str(tmp_path)]
    main = {"infer": infer.main, "test": T.main,
            "train": lambda a: train_cli.main(a, max_steps_override=1)}[cli]
    with pytest.raises(NotImplementedError, match="model level"):
        main(argv)
