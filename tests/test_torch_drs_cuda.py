"""DRSformer's CUDA kernels (MSFN pass 2, MEFC step) against their plain
versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode, and on a CPU tensor the wrappers run the plain
versions that tests/test_torch_drs_kernels.py and
tests/test_torch_drs_mefc.py hold to the JAX package. This file imports no
jax, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_drs_cuda.py -q

Rule (tests/test_tpu_kernels.py's): with the fp32 plain version as the
oracle, the kernel's max error relative to the oracle's max magnitude is
below max(3 x the plain bf16 version's, 4e-3).

Two runs of a kernel give the same bits (no atomics, fixed orders).

Shapes: pass 2 at c 48 (hidden 127, odd) and c 96 with expansion 2.0
(hidden 192, even), both LN types with and without conv biases, at 19x37,
which leaves ragged tiles in both directions; c 192 (hidden 510, even);
the latent level's width (c 384, hidden 1021) at 9x20 and at 37x45
(several tiles each way), and on a batch of two; a 1x1 and a 1-row
image; and every tile height and warp count the wrapper can pick. The MEFC
step at c 48 and 96 on 19x37, on 40x70 (several tiles each way), on a 5x3
image (smaller than its halo), a 1x1 and a 1-row image, on batches of two
whose images have different mix weights (so different M), at every tile
height the wrapper can pick, and at c 64 and 128 (the
kernel built for any width; 48 and 96 have builds of their own).
"""

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.kernels import block as KB
from image_restoration_tpu_torch.kernels import drs_block as K
from image_restoration_tpu_torch.kernels import mefc as M

# (h, w, c, heads, expansion, ln_type, conv biases, batch)
MSFN_CASES = [(19, 37, 48, 1, 2.66, "WithBias", False, 1),
              (19, 37, 48, 1, 2.66, "BiasFree", True, 1),
              (19, 37, 96, 2, 2.0, "WithBias", False, 1),
              (19, 37, 96, 2, 2.0, "BiasFree", True, 1),
              (9, 20, 384, 8, 2.66, "WithBias", False, 1),
              (19, 37, 48, 1, 2.66, "WithBias", True, 1),
              (19, 37, 96, 2, 2.0, "BiasFree", False, 1),
              (21, 40, 192, 4, 2.66, "WithBias", False, 1),
              (37, 45, 384, 8, 2.66, "BiasFree", True, 1),
              (9, 20, 384, 8, 2.66, "WithBias", True, 2),
              (1, 1, 48, 1, 2.66, "WithBias", True, 1),
              (1, 23, 96, 2, 2.66, "BiasFree", False, 1)]
# (h, w, c, batch)
STEP_CASES = [(19, 37, 48, 2), (19, 37, 96, 2), (5, 3, 48, 2),
              (40, 70, 48, 1), (40, 70, 96, 1), (40, 70, 96, 2),
              (1, 1, 48, 1), (1, 23, 96, 1), (1, 23, 48, 2),
              (19, 37, 64, 2), (9, 20, 128, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mk(rng, device):
    def mk(*shape, sc=0.05, base=0.0):
        a = base + sc * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(device)
    return mk


def drs_params(rng, c, heads, expansion, ln_type, device, bias=None):
    """Seeded DRSBlockParams in torch layout; conv biases where ``bias``
    (by default only with BiasFree)."""
    mk = _mk(rng, device)
    h = int(c * expansion)
    bias = ln_type == "BiasFree" if bias is None else bias
    cb = (lambda n: mk(n, sc=0.02)) if bias else (lambda n: None)
    lnb = (lambda: mk(c, sc=0.1)) if ln_type == "WithBias" else (lambda: None)
    return K.DRSBlockParams(
        mk(c, sc=0.1, base=1.0), lnb(),
        mk(3 * c, c, 1, 1, sc=c ** -0.5), cb(3 * c),
        mk(3 * c, 1, 3, 3, sc=0.3), cb(3 * c),
        mk(heads, 1, 1, sc=0.3, base=1.0), mk(4, sc=0.1, base=0.25),
        mk(c, c, 1, 1, sc=c ** -0.5), cb(c),
        mk(c, sc=0.1, base=1.0), lnb(),
        mk(2 * h, c, 1, 1, sc=c ** -0.5), cb(2 * h),
        mk(2 * h, 1, 3, 3, sc=0.3), cb(2 * h),
        mk(2 * h, 1, 5, 5, sc=0.2), cb(2 * h),
        mk(h, 2, 3, 3, sc=0.25), cb(h),
        mk(h, 2, 5, 5, sc=0.15), cb(h),
        mk(c, 2 * h, 1, 1, sc=(2 * h) ** -0.5), cb(c))


def step_params(rng, c, device):
    """Seeded StepParams in torch layout (MEFC is bias-free)."""
    mk = _mk(rng, device)
    one = lambda: mk(c, c, 1, 1, sc=c ** -0.5)  # noqa: E731
    return M.StepParams(
        [mk(c, 1, k, k, sc=1.0 / k) for k in M.SEP_KS],
        [one() for _ in M.SEP_KS],
        [mk(c, 1, k, k, sc=1.0 / k) for k in M.SEP_KS],
        [one() for _ in M.SEP_KS],
        [mk(c, 1, k, k, sc=1.0 / k) for k in M.DIL_KS],
        [one() for _ in M.DIL_KS],
        mk(c, 8 * c, 1, 1, sc=(8 * c) ** -0.5))


def mix_weights(rng, b, device):
    """(B, 8) softmaxed mix weights in bf16, as the Subnet makes them."""
    logits = torch.from_numpy(rng.standard_normal((b, M.NUM_OPS)).astype(np.float32))
    return torch.softmax(logits, -1).to(device, torch.bfloat16)


def _rel(got, oracle):
    scale = oracle.float().abs().max().item() + 1e-12
    return (got.float() - oracle.float()).abs().max().item() / scale


def _msfn_inputs(cuda, h, w, c, heads, expansion, ln_type, seed, bias=None,
                 batch=1):
    rng = np.random.default_rng(seed)
    p = drs_params(rng, c, heads, expansion, ln_type, cuda, bias)
    x = torch.from_numpy(rng.standard_normal((batch, h, w, c)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    v, gram, ss = KB.block_front_ref(x, p.front(), heads)
    atw = K.tksa_finalize(gram, ss, p.temperature, p.mix, p.proj_w,
                          torch.bfloat16)
    return p, x, v, atw


def _check_msfn(v, x, atw, p):
    """The rule against the fp32 oracle, and two runs with equal bits."""
    oracle = K.drs_apply_msfn_ref(v.float(), x.float(), atw.float(), p)
    plain = K.drs_apply_msfn_ref(v, x, atw, p)
    got = K.drs_apply_msfn(v, x, atw, p)
    again = K.drs_apply_msfn(v, x, atw, p)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert _rel(got, oracle) < max(3 * _rel(plain, oracle), 4e-3)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads,expansion,ln_type,bias,batch",
                         MSFN_CASES)
def test_drs_apply_msfn_kernel_vs_plain(cuda, h, w, c, heads, expansion,
                                        ln_type, bias, batch):
    p, x, v, atw = _msfn_inputs(cuda, h, w, c, heads, expansion, ln_type,
                                seed=c + heads, bias=bias, batch=batch)
    _check_msfn(v, x, atw, p)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(48, 1), (96, 2), (192, 4), (384, 8)])
def test_drs_apply_msfn_every_launch_setting(cuda, monkeypatch, c, heads):
    """Every tile height and warp count the wrapper can pick at this width
    (those whose shared memory and registers the card and the builds hold)
    gives the rule and equal bits, on ragged tiles, with a chunk split."""
    p, x, v, atw = _msfn_inputs(cuda, 19, 37, c, heads, 2.66, "BiasFree",
                                seed=7 + c)
    hidden = p.s3_w.shape[0]
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    ran = []
    for warps in (8, 16):
        for th in (8, 4, 2, 1):
            if K._msfn_smem(c, hidden, th, warps) > limit:
                continue
            monkeypatch.setitem(K._MSFN_TILE_ROWS, c, th)
            monkeypatch.setitem(K._MSFN_WARPS, c, warps)
            _check_msfn(v, x, atw, p)
            ran.append((th, warps))
    assert len(ran) >= 4, ran


def _step_inputs(cuda, h, w, c, batch, seed):
    rng = np.random.default_rng(seed)
    sp = step_params(rng, c, cuda)
    x = torch.from_numpy(rng.standard_normal((batch, h, w, c)).astype(np.float32))
    return sp, x.to(cuda, torch.bfloat16), mix_weights(rng, batch, cuda)


def _check_step(x, sp, mix):
    """The rule against the fp32 oracle (M folded in fp32), and two runs
    with equal bits."""
    oracle = M.mefc_step_ref(x.float(), sp, M.fold_step(sp, mix, torch.float32))
    m = M.fold_step(sp, mix, torch.bfloat16)
    plain = M.mefc_step_ref(x, sp, m)
    got = M.mefc_step(x, sp, m)
    again = M.mefc_step(x, sp, m)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert _rel(got, oracle) < max(3 * _rel(plain, oracle), 4e-3)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,batch", STEP_CASES)
def test_mefc_step_kernel_vs_plain(cuda, h, w, c, batch):
    """The rule above and equal bits; a batch's images have different mix
    weights, so each must read its own M."""
    sp, x, mix = _step_inputs(cuda, h, w, c, batch, seed=c + h)
    if batch == 2:
        assert not torch.equal(mix[0], mix[1])
    _check_step(x, sp, mix)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [48, 96])
def test_mefc_step_every_launch_setting(cuda, monkeypatch, c):
    """Every tile height the wrapper can pick at this width (those whose
    shared memory the card and the builds hold) gives the rule and equal
    bits, on ragged tiles and a batch of two."""
    sp, x, mix = _step_inputs(cuda, 19, 37, c, 2, seed=11 + c)
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    ran = []
    for th in (8, 4, 2, 1):
        if M._mefc_smem(c, th) > limit:
            continue
        monkeypatch.setitem(M._MEFC_TILE_ROWS, c, th)
        assert M._mefc_tile_rows(2, 19, 37, c, x.device) == th
        _check_step(x, sp, mix)
        ran.append(th)
    assert len(ran) >= 3, ran


@pytest.mark.cuda
def test_backward_through_the_kernels_raises(cuda):
    """The passes called alone are forward only (as in JAX): a gradient
    must not vanish silently. Through fused_drs_block and fused_mefc_steps
    it is their VJPs' (tests/test_torch_vjp_cuda.py)."""
    p, x, v, atw = _msfn_inputs(cuda, 19, 37, 48, 1, 2.66, "WithBias", seed=3)
    out = K.drs_apply_msfn(v, x.clone().requires_grad_(), atw, p)
    with pytest.raises(NotImplementedError, match="drs_apply_msfn"):
        out.float().sum().backward()
    rng = np.random.default_rng(4)
    sp = step_params(rng, 48, cuda)
    m = M.fold_step(sp, mix_weights(rng, 1, cuda), torch.bfloat16)
    out = M.mefc_step(x.abs().requires_grad_(), sp, m)
    with pytest.raises(NotImplementedError, match="mefc_step"):
        out.float().sum().backward()
    with torch.no_grad():
        assert not M.mefc_step(x.abs().requires_grad_(), sp, m).requires_grad


@pytest.mark.cuda
def test_fused_paths_count_their_launches(cuda):
    p, x, _, _ = _msfn_inputs(cuda, 19, 37, 48, 1, 2.66, "WithBias", seed=0)
    before = (KB.block_front.launches, K.drs_apply_msfn.launches)
    out = K.fused_drs_block(x, p, 1)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (KB.block_front.launches, K.drs_apply_msfn.launches) == (
        before[0] + 1, before[1] + 1)
    rng = np.random.default_rng(1)
    steps = [step_params(rng, 48, cuda) for _ in range(4)]
    weights = torch.stack([mix_weights(rng, 1, cuda) for _ in range(4)], 1)
    n = M.mefc_step.launches
    out = M.fused_mefc_steps(x, steps, weights)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and M.mefc_step.launches == n + 4


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor never falls back to the plain version."""
    p, x, v, atw = _msfn_inputs(cuda, 19, 37, 48, 1, 2.66, "WithBias", seed=2)
    with pytest.raises(TypeError):
        K.drs_apply_msfn(v, x.float(), atw, p)
    with pytest.raises(ValueError):
        K.drs_apply_msfn(v[:, :12], x, atw, p)
    with pytest.raises(ValueError):  # C not a multiple of 16
        K.drs_apply_msfn(v[..., :40].contiguous(), x[..., :40].contiguous(),
                         atw[:, :40, :40].contiguous(), p)
    with pytest.MonkeyPatch.context() as mp:  # no build for 12 warps
        mp.setitem(K._MSFN_WARPS, 48, 12)
        with pytest.raises(ValueError):
            K.drs_apply_msfn(v, x, atw, p)
    sp = step_params(np.random.default_rng(3), 48, cuda)
    m = M.fold_step(sp, mix_weights(np.random.default_rng(4), 1, cuda),
                    torch.bfloat16)
    with pytest.raises(ValueError):
        M.mefc_step(x.transpose(1, 2), sp, m)
    with pytest.raises(ValueError):
        M.mefc_step(x, sp, m[:, :7])
    with pytest.raises(ValueError, match="16-byte"):
        M.mefc_step(x.reshape(-1)[4:4 + 19 * 36 * 48].reshape(1, 19, 36, 48),
                    sp, m)
    with pytest.raises(ValueError, match="16-byte"):
        M.mefc_step(x, sp, torch.zeros(m.numel() + 4, device=cuda,
                                       dtype=m.dtype)[4:].view(m.shape))
