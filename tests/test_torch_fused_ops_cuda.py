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
inputs are test_torch_block_cuda.py's.
"""

import pytest
import torch
from test_torch_block_cuda import _inputs, _rel

from image_restoration_tpu_torch.kernels import attn_core as KA
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


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads,ln_type", CASES)
def test_ln_gdfn_kernel_vs_plain(cuda, h, w, c, heads, ln_type):
    p, x = _inputs(cuda, h, w, c, heads, ln_type, seed=60 + c + heads)
    got = KG.fused_ln_gdfn(x, p.gdfn())
    torch.cuda.synchronize()
    _holds(got, KG.ln_gdfn_ref(x, p.gdfn()),
           KG.ln_gdfn_ref(x.float(), p.gdfn()))


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
    with pytest.raises(TypeError):
        KG.fused_ln_gdfn(x.float(), p.gdfn())
    qkv = KM.ln_qkv_dwconv(x, p.front())
    with pytest.raises(ValueError):
        KA.attn_acc(qkv, 2)  # heads of 24 channels
    at = torch.zeros((1, 1, 48, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        KA.attn_apply(qkv, x[:, :12], at, p.proj_w, p.proj_b)
