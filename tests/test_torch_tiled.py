"""The port's eval/tiled.py against the JAX one.

The same seeded numpy image batch (NHWC for JAX, NCHW for the port) goes
through both packages' tiling with the same functions: a pointwise map, a
3x3 zero-padded conv with shared seeded weights, a map that adds each
window's row index in the batch (so that any difference in window order
shows), and a nearest x2 upsampling for ``scale=2``. Tolerance: 1e-6
absolute (fp32; the conv sums in another order in the two packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_restoration_tpu.eval import tiled as JT
from image_restoration_tpu_torch.eval import tiled as TT

TOL = 1e-6
_W = np.random.default_rng(5).standard_normal((3, 3, 3, 3)).astype(np.float32) * 0.2


def _conv_j(x):
    return jax.lax.conv_general_dilated(
        x, jnp.asarray(_W), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)


def _conv_t(x):
    return F.conv2d(x, torch.from_numpy(_W).permute(3, 2, 0, 1), padding=1)


def _index_j(x):
    return x + 0.01 * jnp.arange(x.shape[0], dtype=x.dtype)[:, None, None, None]


def _index_t(x):
    return x + 0.01 * torch.arange(x.shape[0], dtype=x.dtype)[:, None, None, None]


FNS = {
    "pointwise": (lambda x: 2.0 * x + 0.1, lambda x: 2.0 * x + 0.1),
    "conv": (_conv_j, _conv_t),
    "index": (_index_j, _index_t),
}
UP2 = (lambda x: jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2),
       lambda x: x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


def _img(b, h, w, seed=0):
    return np.random.default_rng(seed).random((b, h, w, 3)).astype(np.float32)


def _t(nhwc):
    return torch.from_numpy(np.ascontiguousarray(nhwc.transpose(0, 3, 1, 2)))


def _close(got, want, tol=TOL):
    got = got.permute(0, 2, 3, 1).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("hw", [(32, 48), (37, 45), (37, 48), (32, 45)],
                         ids=["exact", "both_rem", "h_rem", "w_rem"])
def test_window_roundtrip_batch2(hw):
    """B = 2: the windows and their order equal the JAX ones, and the
    reverse restores the image exactly."""
    x = _img(2, *hw, seed=1)
    wj, mj = JT.window_partition(jnp.asarray(x), 16)
    wt, mt = TT.window_partition(_t(x), 16)
    _close(wt, wj, 0.0)
    assert {k: mt[k] for k in mj if k != "c"} == {k: mj[k] for k in mj if k != "c"}
    _close(TT.window_reverse(wt, mt), x, 0.0)
    _close(TT.window_reverse(wt, mt), JT.window_reverse(wj, mj), 0.0)


@pytest.mark.parametrize("fn", list(FNS))
@pytest.mark.parametrize("max_batch", [None, 5], ids=["one_batch", "chunks"])
def test_windowed_apply(fn, max_batch):
    jf, tf = FNS[fn]
    x = _img(2, 37, 45, seed=2)
    want = JT.windowed_apply(jf, jnp.asarray(x), 16, max_batch=max_batch)
    got = TT.windowed_apply(tf, _t(x), 16, max_batch=max_batch)
    _close(got, want)


@pytest.mark.parametrize("fn", ["pointwise", "conv", "index", "up2"])
def test_overlap_average_apply(fn):
    jf, tf = UP2 if fn == "up2" else FNS[fn]
    scale = 2 if fn == "up2" else 1
    x = _img(2, 30, 26, seed=3)
    want = JT.overlap_average_apply(jf, jnp.asarray(x), patch=12, scale=scale)
    got = TT.overlap_average_apply(tf, _t(x), patch=12, scale=scale)
    _close(got, want)
    got_chunks = TT.overlap_average_apply(tf, _t(x), patch=12, scale=scale,
                                          max_batch=7)
    if fn != "index":  # chunks renumber the rows of a batch
        _close(got_chunks, want)


def test_overlap_average_accumulates_in_output_dtype():
    """bf16 patches sum in bf16, as the JAX accumulator in the output's
    dtype does."""
    x = _img(1, 30, 26, seed=4)
    want = JT.overlap_average_apply(lambda t: t.astype(jnp.bfloat16),
                                    jnp.asarray(x), patch=12)
    got = TT.overlap_average_apply(lambda t: t.to(torch.bfloat16), _t(x),
                                   patch=12)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 0.0)


@pytest.mark.parametrize("fn", ["pointwise", "conv", "up2"])
def test_chop_apply(fn):
    jf, tf = UP2 if fn == "up2" else FNS[fn]
    scale = 2 if fn == "up2" else 1
    x = _img(2, 45, 39, seed=6)
    want = JT.chop_apply(jf, jnp.asarray(x), min_size=200, shave=4,
                         scale=scale)
    got = TT.chop_apply(tf, _t(x), min_size=200, shave=4, scale=scale)
    _close(got, want)


@pytest.mark.parametrize("scale", [1, 2])
def test_pad_test(scale):
    jf, tf = UP2 if scale == 2 else FNS["conv"]
    x = _img(1, 37, 45, seed=8)
    want = JT.pad_test(jf, jnp.asarray(x), 8, scale=scale)
    got = TT.pad_test(tf, _t(x), 8, scale=scale)
    _close(got, want)
