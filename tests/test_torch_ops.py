"""Parity of the port's block library (image_restoration_tpu_torch.ops) with
the JAX package's: LayerNorms, Conv (dense and depthwise), Downsample,
Upsample, pixel (un)shuffle, MDTA and GDFN.

Each JAX module is initialized, its parameters are replaced by seeded
random values, and the same tree is loaded into the port through
``state_dict_from_jax``. Both run on the same numpy input in fp32 (JAX at
"highest" matmul precision, torch with TF32 off); the port takes NCHW, the
JAX package NHWC. Tolerance: rtol=1e-4, atol=1e-5 (fp32 with different
summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu import ops as jops
from image_restoration_tpu.ops import attention as jattn
from image_restoration_tpu.ops import ffn as jffn
from image_restoration_tpu.ops import layernorm as jln
from image_restoration_tpu.ops import resample as jres
from image_restoration_tpu_torch.ops import attention as tattn
from image_restoration_tpu_torch.ops import common as tcommon
from image_restoration_tpu_torch.ops import ffn as tffn
from image_restoration_tpu_torch.ops import layernorm as tln
from image_restoration_tpu_torch.ops import resample as tres
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _randomized(params, rng):
    """Every leaf replaced by seeded values around its init's scale (LN
    weights and temperatures stay near 1)."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                base = 1.0 if k in ("weight", "temperature", "scale") else 0.0
                out[k] = (base + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        return out
    return walk(jax.tree.map(np.asarray, params))


def _pair(jmod, tmod, x_nhwc, rng):
    """Init the JAX module, randomize, load into the torch module; return
    (jax output NHWC, torch output as NHWC numpy)."""
    params = _randomized(jmod.init(jax.random.PRNGKey(0), x_nhwc)["params"], rng)
    tmod.load_state_dict(state_dict_from_jax(params, tmod.state_dict()),
                         strict=True)
    want = np.asarray(jmod.apply({"params": params}, x_nhwc))
    with torch.no_grad():
        got = tmod(torch.from_numpy(np.ascontiguousarray(
            x_nhwc.transpose(0, 3, 1, 2))))
    return want, got.permute(0, 2, 3, 1).numpy()


def _x(rng, c, h=12, w=10, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("ln_type", ["WithBias", "BiasFree"])
def test_layernorm(ln_type, rng):
    x = _x(rng, 24) * 2.0 + 0.5
    want, got = _pair(jln.LayerNorm(ln_type), tln.LayerNorm(24, ln_type), x, rng)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cin,cout,k,pad,groups,bias", [
    (8, 16, 3, 1, 1, True),     # dense 3x3 with bias
    (16, 16, 3, 1, 16, False),  # depthwise 3x3
    (8, 24, 1, 0, 1, False),    # 1x1
    (12, 24, 3, 1, 4, True),    # grouped
])
def test_conv(cin, cout, k, pad, groups, bias, rng):
    jmod = jops.Conv(cout, k, padding=pad, groups=groups, use_bias=bias)
    tmod = tcommon.Conv(cin, cout, k, padding=pad, groups=groups, bias=bias)
    want, got = _pair(jmod, tmod, _x(rng, cin), rng)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_downsample(rng):
    want, got = _pair(jres.Downsample(16), tres.Downsample(16),
                      _x(rng, 16), rng)
    assert got.shape == (2, 6, 5, 32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_upsample(rng):
    want, got = _pair(jres.Upsample(16), tres.Upsample(16), _x(rng, 16), rng)
    assert got.shape == (2, 24, 20, 8)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pixel_shuffle_roundtrip(rng):
    x = _x(rng, 12)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    shuf = tres.pixel_shuffle(xt, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(shuf, np.asarray(jres.pixel_shuffle(x, 2)))
    unshuf = tres.pixel_unshuffle(xt, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(unshuf, np.asarray(jres.pixel_unshuffle(x, 2)))
    back = tres.pixel_unshuffle(tres.pixel_shuffle(xt, 2), 2)
    np.testing.assert_array_equal(back.numpy(), xt.numpy())


@pytest.mark.parametrize("dim,heads,bias", [(16, 1, False), (24, 4, True)])
def test_mdta(dim, heads, bias, rng):
    jmod = jattn.MDTA(dim, heads, bias)
    tmod = tattn.MDTA(dim, heads, bias)
    want, got = _pair(jmod, tmod, _x(rng, dim), rng)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_l2_normalize_matches_jax(rng):
    x = _x(rng, 6)
    x[0, :, :, 0] = 0.0  # an all-zero channel hits the eps clamp
    got = tattn.l2_normalize(torch.from_numpy(x), dim=1).numpy()
    want = np.asarray(jattn.l2_normalize(jnp.asarray(x), axis=1))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dim,bias", [(16, False), (24, True)])
def test_gdfn(dim, bias, rng):
    want, got = _pair(jffn.GDFN(dim, 2.66, bias), tffn.GDFN(dim, 2.66, bias),
                      _x(rng, dim), rng)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gelu_is_exact_erf():
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    got = tcommon.gelu_exact(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.gelu_exact(x)),
                               rtol=1e-5, atol=1e-6)  # erf tails differ ~5e-7


def test_pad_to_multiple_and_crop(rng):
    x = rng.standard_normal((1, 13, 11, 3)).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    padded, hw = tcommon.pad_to_multiple(xt, 8)
    want, whw = jops.pad_to_multiple(jnp.asarray(x), 8)
    assert hw == tuple(whw) == (13, 11) and padded.shape[-2:] == (16, 16)
    np.testing.assert_array_equal(padded.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(tcommon.crop_to(padded, hw).numpy(),
                                  xt.numpy())
