"""The three-kernel Restormer block's CUDA kernels against their plain
versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode, and on a CPU tensor the wrappers run the plain
versions that tests/test_torch_fused_ops.py holds to the JAX package. This
file imports no jax, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_ops_cuda.py -q

Rule (tests/test_tpu_kernels.py's): with the fp32 plain version as the
oracle, the kernel's max error relative to the oracle's max magnitude is
below max(3 x the plain bf16 version's, 4e-3). The attention accumulation
(K5) reads bf16 q and k, which its plain version widens exactly, so it is
held to its plain version on the same map at 1e-5 relative (fp32 sums in
another order), and must give the same bits on a second run.

Shapes: small and odd, (h, w, c, heads) with a ragged 16-pixel tile column
and odd heights, both LN types (the BiasFree cases carry every conv bias),
and the latent level's width (c 384, 8 heads, hidden 1021). Weights and
inputs are test_torch_block_cuda.py's. LN + GDFN (K3) also runs that
file's TAIL_CASES (every edge of the FFN tail it shares with K2) and must
give the same bits on a second run; LN + qkv + depthwise (K4) runs its
FRONT_CASES (the edges of the front it shares with K1) in blocks of 8 and
of 16 warps, with the same two-runs check. The attention core (K5, K6)
runs ATTN_CASES: ragged tiles, fewer tiles than blocks, blocks that walk
several tiles, batch 2 with different images, C = 384's column groups,
and each entry of ``kernels/attn_core.py``'s launch tables forced in turn,
with two bit-equal runs of both kernels. A ``backward()`` through
``attn_acc`` or ``attn_apply`` called alone raises ``NotImplementedError``
(the passes are forward only, as in JAX); through ``ln_qkv_dwconv``,
``fused_mdta_core`` and ``fused_ln_gdfn`` it is the recomputed reference's
(the JAX custom VJPs) and launches no kernel
(tests/test_torch_vjp_cuda.py holds them at more shapes).
"""

import pytest
import torch
from test_torch_block_cuda import FRONT_CASES, TAIL_CASES, _inputs, _rel

from image_restoration_tpu_torch.kernels import attn_core as KA
from image_restoration_tpu_torch.kernels import block as KB
from image_restoration_tpu_torch.kernels import gdfn as KG
from image_restoration_tpu_torch.kernels import mdta as KM

CASES = [(9, 20, 48, 1, "WithBias"), (9, 20, 48, 1, "BiasFree"),
         (7, 37, 32, 2, "WithBias"), (11, 24, 96, 2, "BiasFree"),
         (5, 13, 16, 1, "WithBias"), (12, 20, 384, 8, "WithBias")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _holds(got, plain, oracle):
    assert got.shape == plain.shape and got.dtype == plain.dtype
    assert torch.isfinite(got).all()
    assert _rel(got, oracle) < max(3 * _rel(plain, oracle), 4e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads,ln_type", CASES)
def test_ln_qkv_dwconv_kernel_vs_plain(cuda, h, w, c, heads, ln_type):
    p, x = _inputs(cuda, h, w, c, heads, ln_type, seed=c + heads)
    got = KM.ln_qkv_dwconv(x, p.front())
    torch.cuda.synchronize()
    _holds(got, KM.ln_qkv_dwconv_ref(x, p.front()),
           KM.ln_qkv_dwconv_ref(x.float(), p.front()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,heads,ln_type,bias", sorted(
    {case[:-1] for case in FRONT_CASES}))
@pytest.mark.parametrize("warps", [8, 16])
def test_ln_qkv_dwconv_edges_warps_and_two_equal_runs(cuda, monkeypatch,
                                                      warps, b, h, w, c,
                                                      heads, ln_type, bias):
    monkeypatch.setitem(KM._QKV_WARPS, c, warps)
    p, x = _inputs(cuda, h, w, c, heads, ln_type, seed=h + w + c, batch=b,
                   bias=bias)
    got = KM.ln_qkv_dwconv(x, p.front())
    again = KM.ln_qkv_dwconv(x, p.front())
    torch.cuda.synchronize()
    _holds(got, KM.ln_qkv_dwconv_ref(x, p.front()),
           KM.ln_qkv_dwconv_ref(x.float(), p.front()))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads,ln_type", CASES)
def test_attn_acc_kernel_vs_plain_and_deterministic(cuda, h, w, c, heads,
                                                    ln_type):
    p, x = _inputs(cuda, h, w, c, heads, ln_type, seed=20 + c + heads)
    qkv = KM.ln_qkv_dwconv_ref(x, p.front())
    got = KA.attn_acc(qkv, heads)
    again = KA.attn_acc(qkv, heads)
    torch.cuda.synchronize()
    for g, a, want in zip(got, again, KA.attn_acc_ref(qkv, heads)):
        assert g.shape == want.shape and g.dtype == torch.float32
        assert torch.equal(g, a)
        assert _rel(g, want) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads,ln_type", CASES)
def test_attn_apply_kernel_vs_plain(cuda, h, w, c, heads, ln_type):
    p, x = _inputs(cuda, h, w, c, heads, ln_type, seed=40 + c + heads)
    qkv = KM.ln_qkv_dwconv_ref(x, p.front())
    gram, ss = KA.attn_acc_ref(qkv, heads)
    at = KA.finalize_at(gram, ss, p.temperature, torch.bfloat16)
    got = KA.attn_apply(qkv, x, at, p.proj_w, p.proj_b)
    torch.cuda.synchronize()
    _holds(got, KA.attn_apply_ref(qkv, x, at, p.proj_w, p.proj_b),
           KA.attn_apply_ref(qkv.float(), x.float(), at.float(), p.proj_w,
                             p.proj_b))


# The attention core's edges: (b, h, w, c, heads, K5's (pixels, slots,
# fewest tiles a block walks), K6's (pixels, warps, columns a warp, column
# groups)), each launch-table entry forced in turn. H*W not a
# multiple of the tile (9x20 = 180 pixels), fewer tiles than blocks
# (5x13), persistent blocks that walk several tiles (128x128 at 16 pixels
# a tile, and a fewest walk of 2-8 tiles forced), K5's rings of two and
# three tile slots, batch 2 with different images, C = 384 with its output
# columns split over column groups, and width 96 at one and at two heads.
ATTN_CASES = [
    (1, 9, 20, 48, 1, (128, 2, 1), (128, 8, 48, 1)),
    (1, 9, 20, 48, 1, (16, 3, 4), (16, 4, 16, 1)),
    (2, 11, 24, 96, 2, (128, 3, 1), (64, 8, 48, 1)),
    (1, 5, 13, 96, 1, (128, 2, 8), (64, 8, 48, 1)),
    (1, 5, 13, 96, 1, (32, 3, 1), (128, 8, 96, 1)),
    (2, 12, 20, 192, 4, (64, 2, 2), (64, 8, 96, 1)),
    (1, 12, 20, 192, 4, (16, 3, 1), (16, 4, 16, 2)),
    (1, 12, 20, 384, 8, (64, 2, 1), (32, 4, 48, 4)),
    (2, 7, 37, 384, 8, (32, 3, 4), (16, 8, 16, 4)),
    (1, 12, 20, 384, 8, (64, 3, 1), (32, 8, 96, 4)),
    (1, 128, 128, 48, 1, (16, 2, 1), (16, 8, 16, 1)),
    (1, 128, 128, 96, 1, (16, 3, 4), (16, 8, 48, 1)),
    (1, 64, 64, 384, 8, (16, 3, 2), (16, 4, 48, 4)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,heads,acc_cfg,apply_cfg", ATTN_CASES)
def test_attn_core_edges_tables_and_two_equal_runs(cuda, monkeypatch, b, h,
                                                   w, c, heads, acc_cfg,
                                                   apply_cfg):
    for table, v in zip((KA._ACC_PIXELS, KA._ACC_RING, KA._ACC_WALK),
                        acc_cfg):
        monkeypatch.setitem(table, c, v)
    for table, v in zip((KA._APPLY_PIXELS, KA._APPLY_WARPS, KA._APPLY_COLS,
                         KA._APPLY_GROUPS), apply_cfg):
        monkeypatch.setitem(table, c, v)
    p, x = _inputs(cuda, h, w, c, heads, "WithBias", seed=h + w + c + b,
                   batch=b)
    qkv = KM.ln_qkv_dwconv_ref(x, p.front())
    got = KA.attn_acc(qkv, heads)
    again = KA.attn_acc(qkv, heads)
    torch.cuda.synchronize()
    for g, a, want in zip(got, again, KA.attn_acc_ref(qkv, heads)):
        assert g.shape == want.shape and g.dtype == torch.float32
        assert torch.equal(g, a)
        assert _rel(g, want) < 1e-5
    at = KA.finalize_at(*KA.attn_acc_ref(qkv, heads), p.temperature,
                        torch.bfloat16)
    if b == 2:  # the second image's A^T differs beyond its q and k
        at = torch.cat([at[:1], at[1:].flip(1)]).contiguous()
    out = KA.attn_apply(qkv, x, at, p.proj_w, p.proj_b)
    again = KA.attn_apply(qkv, x, at, p.proj_w, p.proj_b)
    torch.cuda.synchronize()
    _holds(out, KA.attn_apply_ref(qkv, x, at, p.proj_w, p.proj_b),
           KA.attn_apply_ref(qkv.float(), x.float(), at.float(), p.proj_w,
                             p.proj_b))
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads,ln_type", CASES)
def test_ln_gdfn_kernel_vs_plain(cuda, h, w, c, heads, ln_type):
    p, x = _inputs(cuda, h, w, c, heads, ln_type, seed=60 + c + heads)
    got = KG.fused_ln_gdfn(x, p.gdfn())
    torch.cuda.synchronize()
    _holds(got, KG.ln_gdfn_ref(x, p.gdfn()),
           KG.ln_gdfn_ref(x.float(), p.gdfn()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,heads,ln_type", TAIL_CASES)
def test_ln_gdfn_tail_edges_and_two_equal_runs(cuda, b, h, w, c, heads,
                                               ln_type):
    p, x = _inputs(cuda, h, w, c, heads, ln_type, seed=h + w + c, batch=b)
    got = KG.fused_ln_gdfn(x, p.gdfn())
    again = KG.fused_ln_gdfn(x, p.gdfn())
    torch.cuda.synchronize()
    _holds(got, KG.ln_gdfn_ref(x, p.gdfn()),
           KG.ln_gdfn_ref(x.float(), p.gdfn()))
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_backward_through_the_kernels_raises(cuda):
    p, x = _inputs(cuda, 24, 20, 48, 1, "WithBias", seed=2)
    xg = x.clone().requires_grad_()
    fns = (KM.ln_qkv_dwconv, KA.attn_acc, KA.attn_apply, KG.fused_ln_gdfn)
    # ln_qkv_dwconv and fused_ln_gdfn differentiate (their JAX custom VJPs):
    # the backward recomputes the reference and launches nothing
    for api, ref, params in ((KM.ln_qkv_dwconv, KB.reference_front,
                              p.front()),
                             (KG.fused_ln_gdfn, KB.reference_ln_gdfn,
                              p.gdfn())):
        out = api(xg, params)
        before = [f.launches for f in fns]
        (got,) = torch.autograd.grad(out.float().sum(), xg)
        torch.cuda.synchronize()
        assert [f.launches for f in fns] == before
        (want,) = torch.autograd.grad(ref(xg, params).float().sum(), xg)
        assert torch.isfinite(got).all() and _rel(got, want) < 4e-3
    qkv = KM.ln_qkv_dwconv(x, p.front()).requires_grad_()
    gram, ss = KA.attn_acc(qkv, 1)
    with pytest.raises(NotImplementedError, match="attn_acc"):
        (gram.sum() + ss.sum()).backward()
    at = KA.finalize_at(gram.detach(), ss.detach(), p.temperature,
                        torch.bfloat16)
    out = KA.attn_apply(qkv, x, at, p.proj_w, p.proj_b)
    with pytest.raises(NotImplementedError, match="attn_apply"):
        out.float().sum().backward()
    before = KG.fused_ln_gdfn.launches
    assert not KG.fused_ln_gdfn(x, p.gdfn()).requires_grad
    with torch.no_grad():
        assert not KG.fused_ln_gdfn(xg, p.gdfn()).requires_grad
    assert KG.fused_ln_gdfn.launches == before + 2
    with pytest.raises(ValueError, match="16-byte"):
        KG.fused_ln_gdfn(x.reshape(-1)[4:4 + 4 * 20 * 48]
                         .reshape(1, 4, 20, 48), p.gdfn())


@pytest.mark.cuda
def test_three_kernel_block_counts_its_launches(cuda):
    p, x = _inputs(cuda, 24, 20, 96, 2, "WithBias", seed=0)
    fns = (KM.ln_qkv_dwconv, KA.attn_acc, KA.attn_apply, KG.fused_ln_gdfn)
    before = [f.launches for f in fns]
    qkv = KM.ln_qkv_dwconv(x, p.front())
    y = KA.fused_mdta_core(qkv, x, p.temperature, p.proj_w, p.proj_b, 2)
    out = KG.fused_ln_gdfn(y, p.gdfn())
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 1]

    def plain_chain(xx, dt):
        qkv = KM.ln_qkv_dwconv_ref(xx, p.front())
        at = KA.finalize_at(*KA.attn_acc_ref(qkv, 2), p.temperature, dt)
        y = KA.attn_apply_ref(qkv, xx, at, p.proj_w, p.proj_b)
        return KG.ln_gdfn_ref(y, p.gdfn())

    _holds(out, plain_chain(x, torch.bfloat16),
           plain_chain(x.float(), torch.float32))


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor never falls back to the plain version."""
    p, x = _inputs(cuda, 24, 20, 48, 1, "WithBias", seed=1)
    with pytest.raises(TypeError):
        KM.ln_qkv_dwconv(x.float(), p.front())
    with pytest.raises(ValueError):
        KM.ln_qkv_dwconv(x.transpose(1, 2), p.front())
    with pytest.raises(ValueError, match="16-byte"):
        KM.ln_qkv_dwconv(x.reshape(-1)[4:4 + 4 * 20 * 48]
                         .reshape(1, 4, 20, 48), p.front())
    with pytest.raises(TypeError):
        KG.fused_ln_gdfn(x.float(), p.gdfn())
    qkv = KM.ln_qkv_dwconv(x, p.front())
    with pytest.raises(ValueError):
        KA.attn_acc(qkv, 2)  # heads of 24 channels
    at = torch.zeros((1, 1, 48, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        KA.attn_apply(qkv, x[:, :12], at, p.proj_w, p.proj_b)
