"""The port's NIQE and FID (``eval/niqe.py``, ``eval/fid.py``) against the
JAX package's, on the same numpy data.

Both packages compute these metrics on the host in numpy/scipy float64, so
the same input gives the same number: NIQE is held exactly (``==``) and
the Frechet distance within 1e-9 relative. The pristine NIQE parameters
are synthetic (``tests/seeding.py`` ``write_niqe_params``: the repo ships
no ``niqe_pris_params.npz``). NIQE needs at least two 96x96 blocks
(``np.cov`` over the blocks), so images are 192x96 or larger.
"""

import numpy as np
import pytest
import torch
from seeding import write_niqe_params

from image_restoration_tpu.eval import fid as jfid
from image_restoration_tpu.eval import niqe as jniqe
from image_restoration_tpu_torch.eval import fid as tfid
from image_restoration_tpu_torch.eval import niqe as tniqe
from image_restoration_tpu_torch.eval.perceptual import VGG16Features


@pytest.fixture(scope="module")
def pris(tmp_path_factory):
    return write_niqe_params(str(tmp_path_factory.mktemp("niqe") /
                                 "pris.npz"), seed=3)


def _image(seed, h, w):
    """A smooth seeded RGB image in [0, 1] with some texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = 0.5 + 0.3 * np.sin(6 * xx + 4 * yy)[..., None] * np.array(
        [1.0, 0.8, 0.6])
    return np.clip(base + 0.05 * rng.standard_normal((h, w, 3)), 0, 1)


@pytest.mark.parametrize("hw", [(192, 96), (200, 290)])
def test_niqe_equals_jax(pris, hw):
    """The RGB path (MATLAB Y) and a 2-D Y image, with and without a crop
    border where two blocks remain: the port's NIQE equals JAX's
    exactly."""
    img = _image(1, *hw)
    got = tniqe.calculate_niqe(img, params_path=pris)
    assert np.isfinite(got)
    assert got == jniqe.calculate_niqe(img, params_path=pris)
    y = img[..., 0] * 255.0
    for crop in (0, 4) if min(hw) > 192 else (0,):
        assert tniqe.calculate_niqe(y, crop, pris) == jniqe.calculate_niqe(
            y, crop, pris)


def test_niqe_parts_equal_jax():
    """The window, the AGGD fit and the block features."""
    np.testing.assert_array_equal(tniqe.matlab_gaussian_window(),
                                  jniqe.matlab_gaussian_window())
    block = np.random.default_rng(2).standard_normal((96, 96))
    assert tniqe.estimate_aggd_param(block) == jniqe.estimate_aggd_param(
        block)
    assert tniqe._block_features(block) == jniqe._block_features(block)


def test_niqe_needs_params():
    with pytest.raises(FileNotFoundError, match="niqe_params"):
        tniqe.calculate_niqe(_image(0, 192, 96))


def test_niqe_table_step(pris):
    """NIQE is discontinuous in the image: the AGGD shape is an argmin
    over a table with a step of 0.001, so two images that differ by
    rounding can pick neighbouring entries. Over 20 perturbations of 1e-6
    (two restorations of one image on two devices differ by about that)
    the score moves by at most 1e-3 relative here, the tolerance
    ``tests/test_torch_benchmarks.py`` holds two packages' restorations'
    NIQE to."""
    img = _image(4, 192, 192)
    ref = tniqe.calculate_niqe(img, params_path=pris)
    rng = np.random.default_rng(5)
    moved = [abs(tniqe.calculate_niqe(
        img + 1e-6 * rng.standard_normal(img.shape), params_path=pris)
        - ref) / ref for _ in range(20)]
    assert max(moved) <= 1e-3, max(moved)


def test_calculate_fid_equals_jax():
    """Random SPD statistics: the port's distance within 1e-9 relative of
    JAX's, and 0 for identical statistics."""
    rng = np.random.default_rng(6)
    for d in (1, 8, 64):
        a, b = rng.standard_normal((d, d)), rng.standard_normal((d, d))
        s1, s2 = a @ a.T + np.eye(d), b @ b.T + 0.5 * np.eye(d)
        m1, m2 = rng.standard_normal(d), rng.standard_normal(d)
        want = jfid.calculate_fid(m1, s1, m2, s2)
        np.testing.assert_allclose(tfid.calculate_fid(m1, s1, m2, s2), want,
                                   rtol=1e-9)
        assert abs(tfid.calculate_fid(m1, s1, m1, s1)) < 1e-6 * np.trace(s1)


def test_calculate_fid_singular_product():
    """sqrtm of a nilpotent product is not finite: both retry with eps on
    the diagonals and agree."""
    s1 = np.array([[1.0, 0.0], [0.0, 0.0]])
    s2 = np.array([[0.0, 1.0], [0.0, 0.0]])
    m = np.zeros(2)
    want = jfid.calculate_fid(m, s1, m, s2, eps=1e-6)
    got = tfid.calculate_fid(m, s1, m, s2, eps=1e-6)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_calculate_fid_imaginary_component():
    """A product with a negative eigenvalue has a square root with an
    imaginary diagonal: both raise."""
    s1, s2 = np.diag([1.0, -1.0]), np.eye(2)
    m = np.zeros(2)
    for mod in (jfid, tfid):
        with pytest.raises(ValueError, match="Imaginary component"):
            mod.calculate_fid(m, s1, m, s2)


def test_fid_from_vgg_features():
    """FID from the port's VGG16 trunk (seed-1 random weights, the last
    tap pooled over the pixels) over two seeded sets, streamed through
    ``extract_features``: torch features equal to their numpy copies give
    JAX's ``fid_from_features`` within 1e-9."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        vgg = VGG16Features(taps=(8,)).eval()

    @torch.inference_mode()
    def feature_fn(batch):
        return vgg(batch)[-1].float().mean((2, 3))

    gen = torch.Generator().manual_seed(7)
    sets = [[torch.rand((4, 3, 32, 32), generator=gen) * s + o
             for _ in range(3)] for s, o in ((1.0, 0.0), (0.5, 0.3))]
    f1, f2 = (tfid.extract_features(iter(s), feature_fn) for s in sets)
    assert f1.shape == f2.shape == (12, 128)
    want = jfid.fid_from_features(f1, f2)
    np.testing.assert_allclose(tfid.fid_from_features(f1, f2), want,
                               rtol=1e-9)
    np.testing.assert_allclose(tfid.fid_from_features(
        torch.from_numpy(f1), torch.from_numpy(f2)), want, rtol=1e-9)
    np.testing.assert_array_equal(tfid.compute_feature_stats(f1)[1],
                                  jfid.compute_feature_stats(f1)[1])
