"""The port's eval/metrics.py against the JAX one on the same arrays.

Inputs are made from a numpy seed: a batch of two 40x36 RGB pairs in
[0, 1] (NHWC for JAX, NCHW for the port), the target a noisy copy of the
prediction. Tolerances: PSNR 1e-4 dB; SSIM 1e-5 on [0, 1] and 1e-4 for
``ssim_yc`` (0-255 scale, whose variances cancel in fp32 in both packages);
the filter, the map and the Y channel 1e-5 absolute (fp32 summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.eval import metrics as JM
from image_restoration_tpu_torch.eval import metrics as TM

PSNR_TOL = 1e-4
SSIM_TOL = 1e-5
SSIM_YC_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    pred = rng.random((2, 40, 36, 3)).astype(np.float32)
    noise = rng.standard_normal(pred.shape).astype(np.float32) * 0.05
    target = np.clip(pred + noise, 0.0, 1.0).astype(np.float32)
    mask = (rng.random((2, 40, 36, 1)) > 0.3).astype(np.float32)
    mask = np.repeat(mask, 3, axis=-1)
    return pred, target, mask


def _t(nhwc):
    return torch.from_numpy(np.ascontiguousarray(nhwc.transpose(0, 3, 1, 2)))


def _j(nhwc):
    return jnp.asarray(nhwc)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=0, atol=tol)


def test_psnr(pair):
    pred, target, _ = pair
    _close(TM.psnr(_t(pred), _t(target)), JM.psnr(_j(pred), _j(target)),
           PSNR_TOL)
    _close(TM.psnr(_t(pred), _t(target), data_range=2.0),
           JM.psnr(_j(pred), _j(target), data_range=2.0), PSNR_TOL)


def test_masked_psnr(pair):
    pred, target, mask = pair
    _close(TM.masked_psnr(_t(pred), _t(target), _t(mask)),
           JM.masked_psnr(_j(pred), _j(target), _j(mask)), PSNR_TOL)


def test_gaussian_kernel_and_filter(pair):
    pred, _, _ = pair
    kt = TM._gaussian_kernel(11, 1.5)
    kj = JM._gaussian_kernel(11, 1.5)
    _close(kt, kj, 1e-8)
    got = TM._filter2_valid(_t(pred), kt).permute(0, 2, 3, 1)
    want = JM._filter2_valid(_j(pred), kj)
    assert tuple(got.shape) == want.shape == (2, 30, 26, 3)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("sample_covariance", [True, False],
                         ids=["skimage", "basicsr"])
def test_ssim_map(pair, sample_covariance):
    pred, target, _ = pair
    got = TM.ssim_map(_t(pred), _t(target),
                      sample_covariance=sample_covariance).permute(0, 2, 3, 1)
    want = JM.ssim_map(_j(pred), _j(target),
                       sample_covariance=sample_covariance)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("sample_covariance", [True, False],
                         ids=["skimage", "basicsr"])
def test_ssim(pair, sample_covariance):
    pred, target, _ = pair
    _close(TM.ssim(_t(pred), _t(target), sample_covariance=sample_covariance),
           JM.ssim(_j(pred), _j(target), sample_covariance=sample_covariance),
           SSIM_TOL)


def test_masked_ssim(pair):
    pred, target, mask = pair
    _close(TM.masked_ssim(_t(pred), _t(target), _t(mask)),
           JM.masked_ssim(_j(pred), _j(target), _j(mask)), SSIM_TOL)


def test_rgb_to_y(pair):
    pred, _, _ = pair
    got = TM.rgb_to_y(_t(pred)).permute(0, 2, 3, 1)
    want = JM.rgb_to_y(_j(pred))
    assert tuple(got.shape) == want.shape == (2, 40, 36, 1)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("border", [0, 4])
def test_y_channel_protocol(pair, border):
    pred, target, _ = pair
    _close(TM._crop_border(_t(pred), border).permute(0, 2, 3, 1),
           JM._crop_border(_j(pred), border), 0.0)
    _close(TM.psnr_yc(_t(pred), _t(target), border),
           JM.psnr_yc(_j(pred), _j(target), border), PSNR_TOL)
    _close(TM.ssim_yc(_t(pred), _t(target), border),
           JM.ssim_yc(_j(pred), _j(target), border), SSIM_YC_TOL)


def test_ssim_runs_without_tf32(pair, monkeypatch):
    """The filter runs with both TF32 flags off, and the caller's come
    back after."""
    pred, target, _ = pair
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return conv2d(*a, **k)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(TM.F, "conv2d", spy)
    TM.ssim(_t(pred), _t(target))
    assert len(seen) == 10 and set(seen) == {(False, False)}
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (True, True)
