"""Parity of the port's DRSformer modules (image_restoration_tpu_torch.models.
drsformer) with the JAX package's: TKSA, MSFN with an odd and an even
hidden width, SepConvOp, DilConvOp, OperationLayer and the plain Subnet.

Each JAX module is initialized, its parameters are replaced by seeded
random values, and the same tree is loaded into the port through
``state_dict_from_jax`` with ``drsformer_key_map``. Both run on the same
numpy input in fp32 (JAX at "highest" matmul precision, torch with TF32
off); the port takes NCHW, the JAX package NHWC. Tolerance: rtol=1e-4,
atol=1e-5 (fp32 with different summation orders).
"""

import jax
import numpy as np
import pytest
import torch

from image_restoration_tpu.models import drsformer as jd
from image_restoration_tpu_torch.models import drsformer as td
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _randomized(params, rng):
    """Every leaf replaced by seeded values around its init's scale:
    kernels at the fan-in scale, temperatures near 1, attn1..4 near 0.25."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            z = rng.standard_normal(v.shape)
            if k == "kernel":
                z = z / np.sqrt(np.prod(v.shape[:-1]))
            elif k == "temperature":
                z = 1.0 + 0.2 * z
            elif k.startswith("attn"):
                z = 0.25 + 0.1 * z
            else:
                z = 0.3 * z
            out[k] = z.astype(np.float32)
        return out
    return walk(jax.tree.map(np.asarray, params))


def _load(tmod, params):
    tmod.load_state_dict(state_dict_from_jax(params, tmod.state_dict(),
                                             td.drsformer_key_map), strict=True)
    return tmod


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _pair(jmod, tmod, x, rng, *extra):
    params = _randomized(jmod.init(jax.random.PRNGKey(0), x, *extra)["params"],
                         rng)
    _load(tmod, params)
    want = np.asarray(jmod.apply({"params": params}, x, *extra))
    with torch.no_grad():
        got = tmod(_nchw(x), *(torch.from_numpy(np.asarray(e)) for e in extra))
    return want, got.permute(0, 2, 3, 1).numpy()


def _x(rng, c, h=12, w=10, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("dim,heads,bias", [(16, 1, False), (32, 2, True)])
def test_tksa(dim, heads, bias, rng):
    want, got = _pair(jd.TKSA(dim, heads, bias), td.TKSA(dim, heads, bias),
                      _x(rng, dim), rng)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dim,expansion,bias", [
    (24, 2.66, False),  # hidden 63: odd, one group pairs d3[62] with d5[0]
    (16, 2.0, True),    # hidden 32: even
])
def test_msfn(dim, expansion, bias, rng):
    want, got = _pair(jd.MSFN(dim, expansion, bias),
                      td.MSFN(dim, expansion, bias), _x(rng, dim), rng)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_sep_conv_op(k, rng):
    want, got = _pair(jd.SepConvOp(8, k), td.SepConvOp(8, k), _x(rng, 8), rng)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_dil_conv_op(k, rng):
    want, got = _pair(jd.DilConvOp(8, k), td.DilConvOp(8, k), _x(rng, 8), rng)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_operation_layer(rng):
    logits = rng.standard_normal((2, 8)).astype(np.float32)
    weights = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want, got = _pair(jd.OperationLayer(8), td.OperationLayer(8), _x(rng, 8),
                      rng, weights)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_avg_pool_excludes_padding(rng):
    x = _x(rng, 4, 5, 3)
    want = np.asarray(jd._avg_pool3x3_exclude_pad(x))
    got = td.avg_pool3x3_exclude_pad(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_subnet(fused, rng):
    """The JAX plain Subnet's tree, loaded into the port's Subnet; the fused
    one runs the fold and the step kernel's plain version on the CPU."""
    jmod = jd.Subnet(16)
    tmod = td.Subnet(16, fused=fused)
    assert "layers.1._ops.3._ops.6.op.0.weight" in tmod.state_dict()
    want, got = _pair(jmod, tmod, _x(rng, 16), rng)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
