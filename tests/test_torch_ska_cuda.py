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
32), (7, 7, 384 / 48), which take the vectorised path; a ragged 7x9 at
C 24 / wc 6 and C 12 / wc 2, and k = 5, which take the scalar path; and an
unaligned view of x (the scalar path too).
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
    """The kernel is forward only: a gradient must not vanish silently."""
    x, w = _inputs(CASES[0], cuda, seed=5)
    out = K.ska(x.requires_grad_(), w)
    with pytest.raises(NotImplementedError, match="ska"):
        out.sum().backward()
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
