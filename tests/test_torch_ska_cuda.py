"""The SKA CUDA kernel (kernels/ska.py, csrc/ska.cu) against its plain
version, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernel has no CPU mode, and on a CPU tensor the wrapper runs ``ska_plain``,
which tests/test_torch_ska.py holds to the JAX package. This file imports
no jax, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ska_cuda.py -q

Rule: with the fp32 plain version as the oracle, the bf16 kernel's max
error relative to the oracle's max magnitude is below max(3 x the plain
bf16 version's, 4e-3); the fp32 kernel's below 1e-5 (the same fp32 taps
in the same order, fused multiply-adds against separate roundings).

Shapes: LSNet-B's three at batch 4, (28, 28, 128 / wc 16), (14, 14, 256 /
32), (7, 7, 384 / 48), which take the strip kernel; a ragged 7x9 at
C 24 / wc 6 and C 12 / wc 2, and k = 5, which take the scalar path; and an
unaligned view of x and rows too wide for even a one-row strip (the scalar
path too); rows too wide for the tables' strip take one-row strips.
The strip kernel is also held, at launch tables set by the test, to strips
whose rows do not divide H, to 7x7 x 384 images split over blocks by rows,
with one strip a block and with persistent blocks, to a batch whose images
differ (each image's result must not depend on the others), to two
bit-equal runs, and in fp32 at each LSNet-B shape.
"""

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.kernels import ska as K
from image_restoration_tpu_torch.ops.ska import ska_plain

# (B, H, W, C, wc, ks)
CASES = [(4, 28, 28, 128, 16, 3), (4, 14, 14, 256, 32, 3),
         (4, 7, 7, 384, 48, 3), (2, 7, 9, 24, 6, 3), (2, 7, 9, 12, 2, 3),
         (1, 7, 9, 24, 6, 5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(case, device, seed):
    b, h, w, c, wc, ks = case
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c), dtype=np.float32))
    wt = torch.from_numpy(
        rng.standard_normal((b, h, w, wc, ks * ks), dtype=np.float32))
    return x.to(device), wt.to(device)


def _set_config(monkeypatch, c, th, ring, split=1):
    """Launch tables for width ``c`` in bf16 and fp32."""
    for esize in (2, 4):
        monkeypatch.setitem(K._SKA_ROWS, (c, esize), th)
        monkeypatch.setitem(K._SKA_RING, (c, esize), ring)
        monkeypatch.setitem(K._SKA_SPLIT, (c, esize), split)


def _check_both(x, w):
    """The rule in bf16 and fp32; returns the two results."""
    oracle = ska_plain(x, w)
    got32 = K.ska(x, w)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    plain, got = ska_plain(xb, wb), K.ska(xb, wb)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.isfinite(got32).all()
    assert _rel(got32, oracle) <= 1e-5
    assert _rel(got, oracle) < max(3 * _rel(plain, oracle), 4e-3)
    return got, got32


def _rel(got, oracle):
    scale = oracle.float().abs().max().item() + 1e-12
    return (got.float() - oracle.float()).abs().max().item() / scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_vs_plain(cuda, case):
    x, w = _inputs(case, cuda, seed=sum(case))
    oracle = ska_plain(x, w)
    got32 = K.ska(x, w)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    plain = ska_plain(xb, wb)
    got = K.ska(xb, wb)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got32.dtype == torch.float32
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _rel(got32, oracle) <= 1e-5
    assert _rel(got, oracle) < max(3 * _rel(plain, oracle), 4e-3)


@pytest.mark.cuda
def test_unaligned_view_and_launch_count(cuda):
    """A view 2 bytes past an aligned allocation takes the scalar path,
    which sums the same taps in the same order as the vectorised one."""
    x, w = _inputs(CASES[0], cuda, seed=1)
    xa, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    base = torch.empty(xa.numel() + 1, dtype=torch.bfloat16, device=cuda)
    xv = base[1:].view(xa.shape)
    xv.copy_(xa)
    assert xv.is_contiguous() and xv.data_ptr() % 16
    n = K.ska.launches
    got, want = K.ska(xv, wb), K.ska(xa, wb)
    torch.cuda.synchronize()
    assert K.ska.launches == n + 2
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_backward_through_the_kernel_raises(cuda):
    """A gradient must not vanish silently: through the kernel it is SKA's
    VJP (``_SKA``), whose backward kernels give the plain backward's bits
    (tests/test_torch_vjp_cuda.py holds them at every shape)."""
    from image_restoration_tpu_torch.ops.ska import ska_bwd_plain

    x, w = _inputs(CASES[0], cuda, seed=5)
    out = K.ska(x.requires_grad_(), w)
    before = K.ska.launches, K.ska_bwd_x.launches, K.ska_bwd_w.launches
    out.sum().backward()
    torch.cuda.synchronize()
    assert (K.ska.launches, K.ska_bwd_x.launches, K.ska_bwd_w.launches) == (
        before[0], before[1] + 1, before[2])
    assert torch.equal(x.grad, ska_bwd_plain(x.detach(), w,
                                             torch.ones_like(out))[0])
    with torch.no_grad():
        assert not K.ska(x, w).requires_grad
    assert not K.ska(x.detach(), w).requires_grad


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    """A CUDA tensor never falls back to the plain version."""
    x, w = _inputs(CASES[3], cuda, seed=2)
    with pytest.raises(TypeError):
        K.ska(x.half(), w.half())
    with pytest.raises(TypeError):
        K.ska(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError):
        K.ska(x.transpose(1, 2), w)  # (B, W, H, C) vs w's (B, H, W)
    with pytest.raises(ValueError):
        K.ska(x[..., :20], w)  # C 20 not a multiple of wc 6
    with pytest.raises(ValueError):
        K.ska(x, w.cpu())
    with pytest.raises(ValueError):
        K.ska(x[:, :, ::2], w[:, :, ::2])  # not contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("th", [3, 4, 5])
@pytest.mark.parametrize("ring", [1, 2])
def test_strips_that_do_not_divide_h(cuda, monkeypatch, th, ring):
    """H = 13 and 14 at 3-5 rows a strip: the last strip of each image is
    short, and its halo row below the image is zero-filled."""
    _set_config(monkeypatch, 64, th, ring)
    for h in (13, 14):
        x, w = _inputs((2, h, 10, 64, 16, 3), cuda, seed=10 * h + th)
        _check_both(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("th", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("ring", [1, 2])
@pytest.mark.parametrize("split", [1, 2, 8])
def test_deep_map_split_over_blocks(cuda, monkeypatch, th, ring, split):
    """LSNet-B's 7x7 x 384 (wc 48) with each image split into strips of 1
    to 4 rows (7: one strip an image), one strip a block or persistent
    blocks, each unit's 8 channel repeats on 1, 2 or 8 threads, in bf16
    and fp32 (configurations that do not fit take the scalar path)."""
    _set_config(monkeypatch, 384, th, ring, split=split)
    x, w = _inputs((3, 7, 7, 384, 48, 3), cuda, seed=th + 10 * ring + split)
    _check_both(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES[:3], ids=["28x128", "14x256", "7x384"])
def test_images_of_a_batch_are_independent_and_runs_equal(cuda, case):
    """Each image of a batch of different images gives the bits it gives
    alone, and two runs give the same bits, in bf16 and fp32."""
    x, w = _inputs(case, cuda, seed=7)
    for dt in (torch.bfloat16, torch.float32):
        xd, wd = x.to(dt), w.to(dt)
        got = K.ska(xd, wd)
        assert torch.equal(got, K.ska(xd, wd))
        for i in range(x.shape[0]):
            alone = K.ska(xd[i:i + 1].contiguous(), wd[i:i + 1].contiguous())
            assert torch.equal(got[i:i + 1], alone)
        assert not torch.equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES[:3], ids=["28x128", "14x256", "7x384"])
@pytest.mark.parametrize("ring", [1, 2])
def test_fp32_at_lsnet_shapes(cuda, monkeypatch, case, ring):
    """fp32 at LSNet-B's three shapes, at the tables' rows a strip and with
    each ring: within 1e-5 of the fp32 plain version (the same taps in the
    same order, fused multiply-adds against separate roundings)."""
    c = case[3]
    for esize in (2, 4):
        monkeypatch.setitem(K._SKA_RING, (c, esize), ring)
    x, w = _inputs(case, cuda, seed=ring)
    oracle = ska_plain(x, w)
    got = K.ska(x, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and _rel(got, oracle) <= 1e-5


@pytest.mark.cuda
def test_scalar_path_for_rows_too_wide_for_a_strip(cuda, monkeypatch):
    """A 1000-pixel row of 256 channels does not fit a strip in shared
    memory: the scalar kernel takes it, by the same rule."""
    from image_restoration_tpu_torch.kernels.build import load_library

    lib = load_library()
    assert lib.lib.ir_ska_blocks(1000, 256, 32, 0, 1, 1, 1) == 0
    _set_config(monkeypatch, 256, 1, 1)
    x, w = _inputs((1, 3, 1000, 256, 32, 3), cuda, seed=3)
    assert K._plan(lib, x.device, 1, 3, 1000, 256, 32, 0)[3] == 0
    n = K.ska.launches
    _check_both(x, w)
    assert K.ska.launches == n + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dt,w", [(torch.float32, 40), (torch.bfloat16, 72)])
def test_rows_too_wide_for_the_tables_strip(cuda, dt, w):
    """At C 128 the tables' 2-row strips in two slots overflow shared
    memory from W 33 in fp32 and W 66 in bf16: one-row strips one a block
    take such rows, by the same rule, on 5 rows that need several."""
    from image_restoration_tpu_torch.kernels.build import load_library

    lib = load_library()
    fp32 = int(dt == torch.float32)
    th, ring, split = K._config(128, 4 if fp32 else 2)
    assert (th, ring) == (2, 2)
    assert lib.lib.ir_ska_blocks(w, 128, 16, fp32, th, ring, split) == 0
    x, wt = _inputs((2, 5, w, 128, 16, 3), cuda, seed=w)
    x, wt = x.to(dt), wt.to(dt)
    assert K._plan(lib, x.device, 2, 5, w, 128, 16, fp32)[:2] == (1, 1)
    assert K._plan(lib, x.device, 2, 5, w, 128, 16, fp32)[3] > 0
    oracle = ska_plain(x.float(), wt.float())
    got = K.ska(x, wt)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, K.ska(x, wt))
    if fp32:
        assert _rel(got, oracle) <= 1e-5
    else:
        assert _rel(got, oracle) < max(3 * _rel(ska_plain(x, wt), oracle),
                                       4e-3)
