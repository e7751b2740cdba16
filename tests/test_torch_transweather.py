"""The port's TransWeather (``models/transweather.py``) against the JAX
package's, on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``),
the tree goes into the port through ``state_dict_from_jax``, and both run
the same seeded numpy inputs in fp32 (JAX at "highest" matmul precision,
torch with TF32 off); the port takes NCHW images and (B, N, C) tokens, the
JAX package NHWC images and the same tokens.

Tolerance: rtol=1e-4, atol=1e-5 for every module and the whole model (its
output is a tanh, within [-1, 1]). bf16: the port's bf16 output against
JAX's fp32 within 3x the JAX bf16 model's error against it (max and
mean).

* PatchEmbed, SRAttn (sr 1 and 2), TaskQueryAttn with a key/value length
  of 20 and of 70 (the 48 queries nearest-resized down and up), TokenMlp,
  Block (encoder and decoder), ConvTranspose (its (k, k, O, I) kernel
  through the bridge onto torch's (I, O, k, k)), ResidualBlock.
* The whole model at 144x80 (a narrow configuration), where the third and
  fourth encoder stages and the decoder are odd on H (9, 5, 3) and the
  third and fourth on W (5, 3), so both crops of the tail cut;
  ``transweather_key_map``; bf16 (oneDNN off, see that test).
* Stochastic depth: ``train=True`` with a generator drops whole samples'
  branches; ``train=False`` is the eval forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import ATOL, RTOL, init_shapes, load, nchw, nhwc, pair, randomized
from moe_parity import compiled

from image_restoration_tpu.models import transweather as jt
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import transweather as tt


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float()
    got = nhwc(got) if got.dim() == 4 else got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _tokens(rng, n, c, b=2):
    return rng.standard_normal((b, n, c)).astype(np.float32)


def _token_pair(jmod, tmod, rng, t, h, w):
    """(JAX output, port output) of a token module called (t, h, w)."""
    params = randomized(init_shapes(jmod, t, h=h, w=w)["params"], rng)
    load(tmod, params).eval()
    want = jmod.apply({"params": params}, t, h, w)
    with torch.no_grad():
        got = tmod(torch.from_numpy(t), h, w)
    return want, got


def test_patch_embed():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 13, 11, 8)).astype(np.float32)
    (want, wh, ww), (got, gh, gw) = pair(jt.PatchEmbed(16, 3, 2),
                                         tt.PatchEmbed(8, 16, 3, 2), rng, x)
    assert (gh, gw) == (wh, ww) == (7, 6)
    _close(got, want)


@pytest.mark.parametrize("sr", [1, 2])
def test_sr_attn(sr):
    rng = np.random.default_rng(1)
    h, w = 6, 5
    want, got = _token_pair(jt.SRAttn(16, 2, sr), tt.SRAttn(16, 2, sr), rng,
                            _tokens(rng, h * w, 16), h, w)
    _close(got, want)


@pytest.mark.parametrize("hw", [(5, 4), (10, 7)])
def test_task_query_attn(hw):
    """m = 20 and 70 tokens: the 48-query bank resized down and up."""
    rng = np.random.default_rng(2)
    h, w = hw
    want, got = _token_pair(jt.TaskQueryAttn(16, 2), tt.TaskQueryAttn(16, 2),
                            rng, _tokens(rng, h * w, 16), h, w)
    _close(got, want)


def test_token_mlp_and_blocks():
    rng = np.random.default_rng(3)
    h, w = 6, 5
    t = _tokens(rng, h * w, 16)
    want, got = _token_pair(jt.TokenMlp(32, 16), tt.TokenMlp(16, 32, 16),
                            rng, t, h, w)
    _close(got, want)
    for dec in (False, True):
        want, got = _token_pair(
            jt.Block(16, 2, 2.0, 1 if dec else 2, decoder=dec),
            tt.Block(16, 2, 2.0, 1 if dec else 2, decoder=dec), rng, t, h, w)
        _close(got, want)


def test_conv_transpose_and_residual_block():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 7, 12)).astype(np.float32)
    jmod = jt.ConvTranspose(8)
    tmod = tt.ConvTranspose(12, 8)
    want, got = pair(jmod, tmod, rng, x)
    assert got.shape == (2, 8, 10, 14)
    _close(got, want)
    want, got = pair(jt.ResidualBlock(12), tt.ResidualBlock(12), rng, x)
    _close(got, want)


TINY = dict(embed_dims=(16, 32, 40, 64), num_heads=(1, 2, 2, 2),
            depths=(1, 1, 1, 1), dec_depth=1, dec_heads=2)
HW = (144, 80)


@functools.lru_cache(maxsize=None)
def _jax_model(bf16=False):
    rng = np.random.default_rng(10)
    x = rng.random((1, *HW, 3), dtype=np.float32)
    jnet = jt.Transweather(**TINY, dtype=jnp.bfloat16 if bf16 else None)
    params = randomized(init_shapes(jnet, jnp.asarray(x))["params"], rng)
    want = np.asarray(compiled(lambda p, a: jnet.apply({"params": p}, a),
                               params, jnp.asarray(x)), np.float32)
    return params, x, want


def _port(params, dtype=None):
    return load(get_model("transweather", **TINY, dtype=dtype).eval(),
                params, tt.transweather_key_map)


def test_whole_model_odd_stages_matches_jax():
    params, x, want = _jax_model()
    model = _port(params)
    shapes = []
    model.Tenc.register_forward_hook(
        lambda m, i, o: shapes.extend(tuple(f.shape[2:]) for f in o))
    model.Tdec.register_forward_hook(
        lambda m, i, o: shapes.append(tuple(o[0].shape[2:])))
    with torch.inference_mode():
        got = model(nchw(x))
    assert shapes == [(36, 20), (18, 10), (9, 5), (5, 3), (3, 2)]
    assert got.dtype == torch.float32 and got.shape == (1, 3, *HW)
    _close(got, want)


def test_key_map():
    for key in ("Tenc.mini_patch_embed4.proj.weight",
                "convtail.conv_output.conv2d.weight"):
        assert tt.transweather_key_map(key) is None
        assert jt.transweather_key_map(key) is None
    key = "Tdec.block1.0.attn.task_query"
    assert tt.transweather_key_map(key) == key


def test_bf16_within_three_times_jax_bf16():
    """oneDNN off: the CPU's oneDNN bf16 convolution returns wrong sums at
    16 input channels with a 4x4 kernel of stride 4 (stage 1's key/value
    reduction here; errors of the output's size, with torch 2.13's CPU
    build on x86); torch's own CPU convolution is right."""
    params, x, want32 = _jax_model()
    _, _, want16 = _jax_model(bf16=True)
    with torch.inference_mode(), torch.backends.mkldnn.flags(enabled=False):
        got = _port(params, torch.bfloat16)(nchw(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err_port = np.abs(nhwc(got) - want32)
    err_jax = np.abs(want16 - want32)
    assert err_port.max() <= 3 * err_jax.max(), (err_port.max(),
                                                 err_jax.max())
    assert err_port.mean() <= 3 * err_jax.mean(), (err_port.mean(),
                                                   err_jax.mean())


def test_stochastic_depth():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 5, 8, generator=g)
    out = tt.drop_path(x, 0.25, True, g)
    kept = (out != 0).flatten(1).all(1)
    assert ((out == 0).flatten(1).all(1) | kept).all()
    assert 0 < int(kept.sum()) < 64
    torch.testing.assert_close(out[kept], x[kept] / 0.75)
    assert tt.drop_path(x, 0.25, False, g) is x

    params, x, _ = _jax_model()
    model = _port(params)
    with torch.no_grad():
        ref = model(nchw(x))
        same = model(nchw(x), train=False, generator=g)
        dropped = model(nchw(x), train=True,
                        generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(same, ref, rtol=0, atol=0)
    assert not torch.equal(dropped, ref)
