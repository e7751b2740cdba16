"""The port's evaluation data (data/) against the JAX package's.

Trees of PNGs written with PIL from a numpy seed go through the datasets of
both packages; every item must be equal, array for array (exact: both are
the same numpy arithmetic): the benchmark noise bit for bit, the MATLAB
bicubic LR synthesis, the CDD-11 subsets and train crops, the dehaze GT
rule, and the file clients.
"""

import os

import numpy as np
import pytest
from PIL import Image

from image_restoration_tpu.data import augment as JA
from image_restoration_tpu.data import datasets as JD
from image_restoration_tpu.data import degradations as JG
from image_restoration_tpu.data import file_client as JF
from image_restoration_tpu.data import imresize as JI
from image_restoration_tpu_torch.data import augment as TA
from image_restoration_tpu_torch.data import datasets as TD
from image_restoration_tpu_torch.data import degradations as TG
from image_restoration_tpu_torch.data import file_client as TF
from image_restoration_tpu_torch.data import imresize as TI


def _save(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr.astype(np.uint8)).save(path)


def _rand(rng, h, w):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def _items_equal(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            else:
                assert x[k] == y[k], k


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    rng = np.random.default_rng(11)
    r = tmp_path_factory.mktemp("data")
    for i, (h, w) in enumerate([(41, 33), (33, 41)]):
        _save(str(r / f"denoising/bsd68/{i:03d}.png"), _rand(rng, h, w))
        img = _rand(rng, h, w)
        _save(str(r / f"deraining/Rain100L/input/rain-{i}.png"), img)
        _save(str(r / f"deraining/Rain100L/target/rain-{i}.png"), _rand(rng, h, w))
        # SOTS: hazy/<id>_<a>_<b>.png -> clear/<id>.png
        _save(str(r / f"dehazing/SOTS/outdoor/hazy/{i}_0.9_0.2.png"), img)
        _save(str(r / f"dehazing/SOTS/outdoor/clear/{i}.png"), _rand(rng, h, w))
        hr = _rand(rng, 41, 38)
        _save(str(r / f"sr/Set5/HR/im{i}.png"), hr)
        _save(str(r / f"sr/Set5/LR_bicubic/X4/im{i}x4.png"), hr[::4, ::4][:10, :9])
        _save(str(r / f"sr/Set14/HR/im{i}.png"), hr)
    for folder in ["low", "haze", "low_haze", "low_haze_rain"]:
        for i in range(2):
            _save(str(r / f"cdd11/test/{folder}/{i}.png"), _rand(rng, 70, 72))
            _save(str(r / f"cdd11/train/{folder}/{i}.png"), _rand(rng, 70, 72))
    for i in range(2):
        _save(str(r / f"cdd11/test/clear/{i}.png"), _rand(rng, 70, 72))
        _save(str(r / f"cdd11/train/clear/{i}.png"), _rand(rng, 70, 72))
    return str(r)


@pytest.mark.parametrize("sigma", [15.0, 25.0, 50.0])
def test_denoise_benchmark_noise_bit_for_bit(root, sigma):
    d = os.path.join(root, "denoising/bsd68")
    _items_equal(TD.DenoiseBenchmark(d, sigma=sigma),
                 JD.DenoiseBenchmark(d, sigma=sigma))
    t = TD.DenoiseBenchmark(d, sigma=sigma, seed=3, base_crop=None)
    j = JD.DenoiseBenchmark(d, sigma=sigma, seed=3, base_crop=None)
    _items_equal(t, j)
    t.set_sigma(5)
    j.set_sigma(5)
    _items_equal(t, j)


def test_gaussian_noise_np():
    clean = (np.random.default_rng(2).random((9, 7, 3)) * 255).astype(np.uint8)
    for sigma in (15.0, 50.0):
        got = TG.add_gaussian_noise_np(clean, sigma, np.random.default_rng(4))
        want = JG.add_gaussian_noise_np(clean, sigma, np.random.default_rng(4))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert TG.SIGMA_BY_DE_ID == JG.SIGMA_BY_DE_ID


@pytest.mark.parametrize("kw", [{}, {"base_crop": 16}], ids=["whole", "base16"])
def test_paired_folder(root, kw):
    a = os.path.join(root, "deraining/Rain100L/input")
    b = os.path.join(root, "deraining/Rain100L/target")
    _items_equal(TD.PairedFolderDataset(a, b, **kw),
                 JD.PairedFolderDataset(a, b, **kw))


def test_dehaze_rule(root):
    a = os.path.join(root, "dehazing/SOTS/outdoor/hazy")
    b = os.path.join(root, "dehazing/SOTS/outdoor")
    t = TD.PairedFolderDataset(a, b, dehaze_rule=True)
    _items_equal(t, JD.PairedFolderDataset(a, b, dehaze_rule=True))
    assert t.gts[0].endswith(os.path.join("outdoor", "clear", "0.png"))
    for p in ["/d/SOTS/outdoor/hazy/0001_0.8_0.2.jpg", "x/hazy/12.png"]:
        assert TD.dehaze_gt_name(p) == JD.dehaze_gt_name(p)


@pytest.mark.parametrize("synth", [None, True], ids=["lr_folder", "synthesize_lr"])
def test_sr_benchmark(root, synth):
    d = os.path.join(root, "sr/Set5")
    t = TD.SRBenchmark(d, scale=4, synthesize_lr=synth)
    _items_equal(t, JD.SRBenchmark(d, scale=4, synthesize_lr=synth))
    assert t.synthesize_lr == bool(synth)
    # no LR folder: the LR is synthesized by the MATLAB bicubic
    d14 = os.path.join(root, "sr/Set14")
    t14 = TD.SRBenchmark(d14, scale=3)
    assert t14.synthesize_lr
    _items_equal(t14, JD.SRBenchmark(d14, scale=3))
    assert t14[0]["lq"].shape == (13, 12, 3) and t14[0]["gt"].shape == (39, 36, 3)


@pytest.mark.parametrize("subset", ["all", "single", "double", "triple",
                                    "low_haze"])
def test_cdd11_test_subsets(root, subset):
    t = TD.CDD11(root, "test", subset)
    _items_equal(t, JD.CDD11(root, "test", subset))
    want = {"all": 8, "single": 4, "double": 2, "triple": 2, "low_haze": 2}
    assert len(t) == want[subset]
    assert t[0]["lq"].shape == (64, 64, 3)


def test_cdd11_train_crops(root):
    """The train split's crops and flips come from the seeded rng."""
    t = TD.CDD11(root, "train", "double", patch_size=32, seed=9)
    _items_equal(t, JD.CDD11(root, "train", "double", patch_size=32, seed=9))
    assert len(t) == 4 and t[0]["lq"].shape == (32, 32, 3)
    with pytest.raises(ValueError, match="nothing under"):
        TD.CDD11(root, "test", "quadruple")


@pytest.mark.parametrize("mode", range(8))
def test_data_augmentation(mode):
    img = np.random.default_rng(mode).random((5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(TA.data_augmentation(img, mode),
                                  JA.data_augmentation(img, mode))


def test_augment_crops():
    rng = np.random.default_rng(0)
    a, b = rng.random((40, 50, 3)), rng.random((40, 50, 3))
    for got, want in zip(TA.paired_random_crop(a, b, 16, np.random.default_rng(1)),
                         JA.paired_random_crop(a, b, 16, np.random.default_rng(1))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(TA.random_augmentation(a, b, rng=np.random.default_rng(2)),
                         JA.random_augmentation(a, b, rng=np.random.default_rng(2))):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TA.crop_img_to_base(a, 16),
                                  JA.crop_img_to_base(a, 16))
    with pytest.raises(ValueError):
        TA.data_augmentation(a, 8)


@pytest.mark.parametrize("kernel", ["cubic", "box", "lanczos2", "lanczos3"])
@pytest.mark.parametrize("boundary", ["mirror", "renorm"])
def test_imresize_numpy_path(kernel, boundary):
    im = np.random.default_rng(3).random((23, 19, 3)) * 255
    for kw in ({"scale_factor": 0.25}, {"scale_factor": 1 / 3},
               {"scale_factor": 2}, {"output_shape": (11, 30)}):
        np.testing.assert_array_equal(
            TI.imresize(im, kernel=kernel, boundary=boundary, **kw),
            JI.imresize(im, kernel=kernel, boundary=boundary, **kw))
    np.testing.assert_array_equal(
        TI.imresize(im[..., 0], 0.5, antialiasing=False),
        JI.imresize(im[..., 0], 0.5, antialiasing=False))


def test_file_client(tmp_path):
    img = (np.random.default_rng(6).random((9, 11, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "a.png")
    Image.fromarray(img).save(path)
    buf = TF.FileClient("disk").get(path)
    assert buf == JF.FileClient("disk").get(path)
    np.testing.assert_array_equal(TF.imread_bytes(buf), JF.imread_bytes(buf))
    with pytest.raises(ValueError, match="unknown file client"):
        TF.FileClient("s3")
    try:
        import lmdb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="requires the 'lmdb' package"):
            TF.FileClient("lmdb", db_path=str(tmp_path / "db"))
    cached = TF.NpyCachedImage(path, cache_dir=str(tmp_path / "c"))
    first = cached.load()
    assert os.path.exists(cached.cache_path)
    np.testing.assert_array_equal(first, cached.load())
    np.testing.assert_array_equal(
        first, JF.NpyCachedImage(path, cache_dir=str(tmp_path / "j")).load())
    rep = TF.RepeatDataset([10, 20, 30], 3)
    assert len(rep) == 9 and [rep[i] for i in (0, 4, 8)] == [10, 20, 30]
