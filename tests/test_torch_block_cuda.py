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

Pass 1 (K1) also runs FRONT_CASES, which reach every edge of the front it
shares with K4 (csrc/front.cuh): ragged tiles both ways, a 1x1 and a 1-row
image, a batch of two, both LN types with and without conv biases, C 384
with 8 heads, both block sizes and every count of Gram fragments a warp
holds; two runs must give the same bits (v, Gram and sums of squares).

Pass 2 (K2) also runs TAIL_CASES, which reach every edge of the FFN tail it
shares with K3: heights that are no multiple of the tile rows (8 at c 48
and 192, 4 at 96, 2 at 384), widths that are no multiple of 16, hidden
widths 127 and 1021 (padded to 128 and 1024 with zero weights), a batch of
two, both LN types, with and without conv biases. Two runs must give the
same bits. Both also run Restormer-base's latent level in training, a
batch of 8 at 16x16 x 384. A ``backward()`` through ``block_front`` or
``block_apply_gdfn`` alone raises ``NotImplementedError`` (the passes are
forward only) instead of leaving the parameters without gradients; through
``fused_block`` it is ``reference_block``'s, recomputed (the JAX custom
VJP), and launches neither kernel.
"""

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.kernels import block as K

CASES = [(24, 20, c, heads, ln) for c, heads in ((48, 1), (96, 1), (96, 2))
         for ln in ("WithBias", "BiasFree")] + [(12, 20, 384, 8, "WithBias")]
# (batch, h, w, c, heads, ln_type, conv biases, warps); K1 at 8 warps holds
# 1 (c 16), 2 (48), 3 (96, 2 heads), 5 (96, 1 head; 192) or 9 (384) Gram
# fragments a warp, at 16 warps 1, 1, 2, 3, 3.
FRONT_CASES = [
    (1, 13, 21, 48, 1, "WithBias", False, 8),
    (1, 13, 21, 48, 1, "WithBias", True, 16),
    (2, 7, 37, 48, 1, "BiasFree", True, 8),
    (2, 7, 37, 48, 1, "BiasFree", False, 16),
    (1, 1, 1, 16, 1, "WithBias", True, 8),
    (1, 1, 1, 16, 1, "BiasFree", False, 16),
    (1, 1, 40, 96, 2, "BiasFree", False, 8),
    (1, 1, 40, 96, 2, "WithBias", True, 16),
    (1, 10, 33, 96, 1, "WithBias", True, 8),
    (1, 10, 33, 96, 1, "BiasFree", False, 16),
    (1, 19, 24, 192, 4, "WithBias", False, 8),
    (2, 6, 35, 192, 4, "BiasFree", True, 16),
    (2, 5, 19, 384, 8, "BiasFree", True, 8),
    (1, 3, 16, 384, 8, "WithBias", False, 8),
    (8, 16, 16, 384, 8, "WithBias", False, 8),
]
# (batch, h, w, c, heads, ln_type)
TAIL_CASES = [(1, 13, 21, 48, 1, "WithBias"), (2, 7, 37, 48, 1, "BiasFree"),
              (1, 10, 33, 96, 2, "BiasFree"), (1, 19, 24, 192, 4, "WithBias"),
              (2, 5, 19, 384, 8, "BiasFree"), (2, 3, 16, 384, 8, "WithBias"),
              (1, 1, 1, 48, 1, "BiasFree"), (8, 16, 16, 384, 8, "WithBias")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(rng, c, heads, ln_type, device, bias=None):
    """Seeded BlockParams in torch layout; conv biases if ``bias``, by
    default only with BiasFree."""
    hidden = int(c * 2.66)
    bias = ln_type == "BiasFree" if bias is None else bias

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


def _inputs(cuda, h, w, c, heads, ln_type, seed, batch=1, bias=None):
    rng = np.random.default_rng(seed)
    p = _params(rng, c, heads, ln_type, cuda, bias)
    x = torch.from_numpy(rng.standard_normal((batch, h, w, c))
                         .astype(np.float32))
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
@pytest.mark.parametrize("b,h,w,c,heads,ln_type,bias,warps", FRONT_CASES)
def test_block_front_edges_warps_and_two_equal_runs(cuda, monkeypatch, b, h,
                                                    w, c, heads, ln_type,
                                                    bias, warps):
    monkeypatch.setitem(K._FRONT_WARPS, c, warps)
    p, x = _inputs(cuda, h, w, c, heads, ln_type, seed=h + w + c, batch=b,
                   bias=bias)
    oracle = K.block_front_ref(x.float(), p, heads)
    plain = K.block_front_ref(x, p, heads)
    got = K.block_front(x, p, heads)
    again = K.block_front(x, p, heads)
    torch.cuda.synchronize()
    for name, o, pl, g, a in zip(("v", "gram", "sumsq"), oracle, plain, got,
                                 again):
        assert g.shape == pl.shape and g.dtype == pl.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, o) < max(3 * _rel(pl, o), 4e-3), name
        assert torch.equal(g, a), name


@pytest.mark.cuda
def test_block_front_raises_where_no_block_size_holds_the_gram(cuda,
                                                               monkeypatch):
    """8 heads of 48 need 5 Gram fragments a warp at 16 warps, which is not
    built: the wrapper raises instead of running something else."""
    monkeypatch.setitem(K._FRONT_WARPS, 384, 16)
    p, x = _inputs(cuda, 3, 16, 384, 8, "WithBias", seed=3)
    with pytest.raises(ValueError, match="shared memory"):
        K.block_front(x, p, 8)


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
@pytest.mark.parametrize("b,h,w,c,heads,ln_type", TAIL_CASES)
def test_block_apply_gdfn_tail_edges_and_two_equal_runs(cuda, b, h, w, c,
                                                        heads, ln_type):
    p, x = _inputs(cuda, h, w, c, heads, ln_type, seed=h + w + c, batch=b)
    v, gram, ss = K.block_front_ref(x, p, heads)
    atw = K.finalize(gram, ss, p.temperature, p.proj_w, torch.bfloat16)
    oracle = K.block_apply_gdfn_ref(v.float(), x.float(), atw.float(), p)
    plain = K.block_apply_gdfn_ref(v, x, atw, p)
    got = K.block_apply_gdfn(v, x, atw, p)
    again = K.block_apply_gdfn(v, x, atw, p)
    torch.cuda.synchronize()
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _rel(got, oracle) < max(3 * _rel(plain, oracle), 4e-3)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_backward_through_the_kernels_raises(cuda):
    p, x = _inputs(cuda, 24, 20, 48, 1, "WithBias", seed=2)
    v, gram, ss = K.block_front(x.clone().requires_grad_(), p, 1)
    assert v.requires_grad and gram.requires_grad and ss.requires_grad
    with pytest.raises(NotImplementedError, match="block_front"):
        (v.float().sum() + gram.sum()).backward()
    v, atw = v.detach(), K.finalize(gram, ss, p.temperature, p.proj_w,
                                    torch.bfloat16).detach()
    out = K.block_apply_gdfn(v, x.clone().requires_grad_(), atw, p)
    with pytest.raises(NotImplementedError, match="block_apply_gdfn"):
        out.float().sum().backward()
    # the whole block differentiates: the backward recomputes
    # reference_block (up to cuDNN's run-to-run order) and launches nothing
    pg = p._replace(out_w=p.out_w.clone().requires_grad_())
    xg = x.clone().requires_grad_()
    before = (K.block_front.launches, K.block_apply_gdfn.launches)
    out = K.fused_block(xg, pg, 1)
    assert (K.block_front.launches, K.block_apply_gdfn.launches) == (
        before[0] + 1, before[1] + 1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    g = torch.randn(out.shape, generator=gen, device=cuda)
    got = torch.autograd.grad((out.float() * g).sum(), [xg, pg.out_w])
    assert (K.block_front.launches, K.block_apply_gdfn.launches) == (
        before[0] + 1, before[1] + 1)
    ref = K.reference_block(xg, pg, 1)
    want = torch.autograd.grad((ref.float() * g).sum(), [xg, pg.out_w])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        assert _rel(a, b) < 4e-3
    # serving: nothing requires grad, or grad mode is off
    before = K.block_apply_gdfn.launches
    assert not K.block_apply_gdfn(v, x, atw, p).requires_grad
    with torch.no_grad():
        assert not K.fused_block(x.clone().requires_grad_(), pg, 1) \
            .requires_grad
    assert K.block_apply_gdfn.launches == before + 2


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
    with pytest.raises(ValueError, match="16-byte"):
        K.block_front(x.reshape(-1)[4:4 + 4 * 20 * 48].reshape(1, 4, 20, 48),
                      p, 1)
    atw = torch.zeros((1, 48, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        K.block_apply_gdfn(x[:, :12], x, atw, p)
