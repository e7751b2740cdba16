"""The whole-block CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode, and on a CPU tensor the wrappers run the plain
versions that tests/test_torch_block.py holds to the JAX package. This file
imports no jax, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_block_cuda.py -q

Rule (tests/test_tpu_kernels.py's): with the fp32 plain version as the
oracle, the kernel's max error relative to the oracle's max magnitude is
below max(3 x the plain bf16 version's, 4e-3).

Shapes: (c, heads) in {(48, 1), (96, 1), (96, 2)}, both LN types (the
BiasFree cases carry every conv bias), at 24x20, which leaves a ragged
16-pixel tile column; plus the latent level's width (c 384, 8 heads, hidden
1021) at 12x20. The kernels take head widths that are multiples of 16 (48
and 96 at every level of Restormer-base); c 48 with 2 heads must raise.
"""

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.kernels import block as K

CASES = [(24, 20, c, heads, ln) for c, heads in ((48, 1), (96, 1), (96, 2))
         for ln in ("WithBias", "BiasFree")] + [(12, 20, 384, 8, "WithBias")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(rng, c, heads, ln_type, device):
    """Seeded BlockParams in torch layout; conv biases only with BiasFree."""
    hidden = int(c * 2.66)
    bias = ln_type == "BiasFree"

    def mk(*shape, sc=0.05, base=0.0):
        a = base + sc * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(device)

    cb = (lambda n: mk(n, sc=0.02)) if bias else (lambda n: None)
    lnb = (lambda: mk(c, sc=0.1)) if ln_type == "WithBias" else (lambda: None)
    return K.BlockParams(
        mk(c, sc=0.1, base=1.0), lnb(),
        mk(3 * c, c, 1, 1, sc=c ** -0.5), cb(3 * c),
        mk(3 * c, 1, 3, 3, sc=0.3), cb(3 * c),
        mk(heads, 1, 1, sc=0.3, base=1.0),
        mk(c, c, 1, 1, sc=c ** -0.5), cb(c),
        mk(c, sc=0.1, base=1.0), lnb(),
        mk(2 * hidden, c, 1, 1, sc=c ** -0.5), cb(2 * hidden),
        mk(2 * hidden, 1, 3, 3, sc=0.3), cb(2 * hidden),
        mk(c, hidden, 1, 1, sc=hidden ** -0.5), cb(c))


def _inputs(cuda, h, w, c, heads, ln_type, seed):
    rng = np.random.default_rng(seed)
    p = _params(rng, c, heads, ln_type, cuda)
    x = torch.from_numpy(rng.standard_normal((1, h, w, c)).astype(np.float32))
    return p, x.to(cuda, torch.bfloat16)


def _rel(got, oracle):
    scale = oracle.float().abs().max().item() + 1e-12
    return (got.float() - oracle.float()).abs().max().item() / scale


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads,ln_type", CASES)
def test_block_front_kernel_vs_plain(cuda, h, w, c, heads, ln_type):
    p, x = _inputs(cuda, h, w, c, heads, ln_type, seed=c + heads)
    oracle = K.block_front_ref(x.float(), p, heads)
    plain = K.block_front_ref(x, p, heads)
    got = K.block_front(x, p, heads)
    torch.cuda.synchronize()
    for name, o, pl, g in zip(("v", "gram", "sumsq"), oracle, plain, got):
        assert g.shape == pl.shape and g.dtype == pl.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, o) < max(3 * _rel(pl, o), 4e-3), name


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads,ln_type", CASES)
def test_block_apply_gdfn_kernel_vs_plain(cuda, h, w, c, heads, ln_type):
    p, x = _inputs(cuda, h, w, c, heads, ln_type, seed=10 + c + heads)
    v, gram, ss = K.block_front_ref(x, p, heads)
    atw = K.finalize(gram, ss, p.temperature, p.proj_w, torch.bfloat16)
    oracle = K.block_apply_gdfn_ref(v.float(), x.float(), atw.float(), p)
    plain = K.block_apply_gdfn_ref(v, x, atw, p)
    got = K.block_apply_gdfn(v, x, atw, p)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert _rel(got, oracle) < max(3 * _rel(plain, oracle), 4e-3)


@pytest.mark.cuda
def test_fused_block_counts_one_launch_per_pass(cuda):
    p, x = _inputs(cuda, 24, 20, 48, 1, "WithBias", seed=0)
    before = (K.block_front.launches, K.block_apply_gdfn.launches)
    out = K.fused_block(x, p, 1)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (K.block_front.launches, K.block_apply_gdfn.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor never falls back to the plain version."""
    p, x = _inputs(cuda, 24, 20, 48, 1, "WithBias", seed=1)
    with pytest.raises(TypeError):
        K.block_front(x.float(), p, 1)
    with pytest.raises(ValueError):
        K.block_front(x.transpose(1, 2), p, 1)
    with pytest.raises(ValueError):
        K.block_front(x, p, 2)  # heads of 24 channels
    atw = torch.zeros((1, 48, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        K.block_apply_gdfn(x[:, :12], x, atw, p)
