"""The padded channel layouts of the kernel APIs (``kernels/widths.py``),
which run the kernels at every width the JAX kernels take.

* ``pad_channels`` / ``unpad_channels`` round-trip, per head and per
  q/k/v slot, on any axis; ``real_stats`` and ``pad_square`` place the
  real entries where the padded layout puts them.
* Every pad is exactly 0 after each plain pass the kernel APIs run in the
  padded space (K1-K8's plain versions, which the CUDA kernels are held to
  on the card), in bf16, given padded inputs and weights.
* The padded path equals the unpadded plain path in fp32 (atol 1e-5): the
  same passes run at the real width, for the pair (with CG-IR's gate and a
  per-sample temperature), the three-kernel block, DRSformer's block and
  the MEFC steps, at C 24, 40, 48 in 2 heads and 80.
* The kernel APIs' backwards save the real-width inputs and give the
  plain compositions' gradients (fp32, 1e-5 of the largest).
* A whole Restormer at dim 24 (heads 1/2/4/8: every head 24 wide), blocks
  1/1/1/1, with ``fused_block`` on, against the JAX Restormer with
  ``fused_block`` on and its Pallas kernels in interpret mode on their
  128-lane canvas, at 32x32 in bf16, by test_torch_fused_ops.py's bf16
  rule (max difference 5%, mean 1% of max|JAX output|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.kernels import block_pallas as JK
from image_restoration_tpu.models.restormer import Restormer as JRestormer
from image_restoration_tpu_torch.kernels import attn_core as TA
from image_restoration_tpu_torch.kernels import block as TB
from image_restoration_tpu_torch.kernels import drs_block as TD
from image_restoration_tpu_torch.kernels import gdfn as TG
from image_restoration_tpu_torch.kernels import mdta as TM
from image_restoration_tpu_torch.kernels import mefc as TF
from image_restoration_tpu_torch.kernels import widths as TW
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models.drsformer import OperationLayer
from image_restoration_tpu_torch.models.drsformer import (
    TransformerBlock as DRSBlock,
)
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

H, W, EPS = 6, 10, 1e-5
# (C, heads): head widths 24, 40, 24 and 80; the pair pads them to 32, 48,
# 32 and 80, K5/K6 to 32, 48, 32 and 96
SHAPES = [(24, 1), (40, 1), (48, 2), (80, 1)]


def _block_params(c, heads, seed, bias=True):
    """A BlockParams from ``seed``: LN affines near 1 and 0, every conv bias
    when ``bias``."""
    g = torch.Generator().manual_seed(seed)
    hidden = int(c * 2.66)

    def r(*shape, sc=0.1, base=0.0):
        return base + sc * torch.randn(*shape, generator=g)

    cb = (lambda n: r(n, sc=0.02)) if bias else (lambda n: None)
    return TB.BlockParams(
        r(c, base=1.0), r(c), r(3 * c, c, 1, 1, sc=c ** -0.5), cb(3 * c),
        r(3 * c, 1, 3, 3, sc=0.3), cb(3 * c), r(heads, 1, 1, sc=0.3, base=1.0),
        r(c, c, 1, 1, sc=c ** -0.5), cb(c), r(c, base=1.0), r(c),
        r(2 * hidden, c, 1, 1, sc=c ** -0.5), cb(2 * hidden),
        r(2 * hidden, 1, 3, 3, sc=0.3), cb(2 * hidden),
        r(c, hidden, 1, 1, sc=hidden ** -0.5), cb(c))


def _drs_params(c, heads, seed):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        blk = DRSBlock(c, heads)
        with torch.no_grad():
            for mod in (blk.norm1.body, blk.norm2.body):
                mod.weight.add_(0.2 * torch.randn(c))
                mod.bias.add_(0.2 * torch.randn(c))
            blk.attn.temperature.copy_(0.5 + torch.rand(heads, 1, 1))
    return TD.DRSBlockParams(*(None if t is None else t.detach()
                               for t in blk.block_params()))


def _steps(c, n, seed):
    def detached(f):
        return [t.detach() for t in f] if isinstance(f, list) else f.detach()

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        steps = [OperationLayer(c).step_params() for _ in range(n)]
        weights = torch.softmax(torch.randn(2, n, TF.NUM_OPS), -1)
    return [TF.StepParams(*map(detached, sp)) for sp in steps], weights


def _x(c, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, H, W, c, generator=g).to(dtype)


def _pads(t, lay, slots=1):
    """The pad channels of the last axis of ``t`` in ``lay``."""
    parts = t.reshape(*t.shape[:-1], slots * lay.heads, lay.chp)
    return parts[..., lay.ch:]


# ------------------------------------------------------------- layouts ---

@pytest.mark.parametrize("c,heads,chp", [(24, 1, 32), (48, 2, 32),
                                         (80, 1, 96), (96, 4, 32),
                                         (48, 1, 48)])
def test_pad_channels_round_trips(c, heads, chp):
    lay = TW.head_layout(c, heads, chp)
    assert lay.cp == heads * chp and lay.padded == (chp != c // heads)
    x = torch.randn(2, 3, 3 * c, 5)
    xp = TW.pad_channels(x, lay, 3, dim=2)
    assert xp.shape == (2, 3, 3 * lay.cp, 5)
    assert torch.equal(TW.unpad_channels(xp, lay, 3, dim=2), x)
    # real channel j of head i of slot s lies at s * cp + i * chp + j
    s, i, j = 2, heads - 1, c // heads - 1
    assert torch.equal(xp[:, :, s * lay.cp + i * chp + j],
                       x[:, :, s * c + i * (c // heads) + j])
    pads = xp.movedim(2, -1).reshape(2, 3, 5, 3 * heads, chp)[..., c // heads:]
    assert not pads.any()
    assert TW.pad_channels(None, lay) is None


def test_real_stats_and_pad_square_place_the_real_entries():
    lay = TW.head_layout(48, 2, 32)
    gram = torch.randn(2, 2, 32, 32)
    ss = torch.randn(2, 2, 64)
    g, s = TW.real_stats(gram, ss, lay)
    assert torch.equal(g, gram[..., :24, :24])
    assert torch.equal(s, torch.cat([ss[..., :24], ss[..., 32:56]], -1))
    m = torch.randn(2, 48, 48)
    mp = TW.pad_square(m, lay)
    idx = torch.cat([torch.arange(24), 32 + torch.arange(24)])
    assert torch.equal(mp[:, idx][:, :, idx], m)
    mp[:, idx[:, None], idx] = 0
    assert not mp.any()


# -------------------------------------------------- pads stay exactly 0 ---

@pytest.mark.parametrize("c,heads", SHAPES)
def test_pads_stay_zero_through_every_padded_plain_pass(c, heads):
    bf = torch.bfloat16
    p = _block_params(c, heads, seed=c)
    x = _x(c, seed=1, dtype=bf)

    lay = TB.front_layout(c, heads)
    xp, pp = TW.pad_channels(x, lay), TB.pad_block_params(p, lay)
    v, gram, ss = TB.block_front(xp, pp.front(), heads, EPS, c)
    assert not _pads(v, lay).any() and not _pads(ss, lay).any()
    assert not gram[..., lay.ch:, :].any() and not gram[..., lay.ch:].any()
    g, s = TW.real_stats(gram, ss, lay)
    atw = TW.pad_square(TB.finalize(g, s, p.temperature, p.proj_w, bf), lay)
    assert not _pads(TB.block_apply_gdfn(v, xp, atw, pp, EPS, c), lay).any()

    flat = TW.flat_layout(c)
    xf = TW.pad_channels(x, flat)
    qkv = TM.ln_qkv_dwconv_ref(xf, TB.pad_front_params(p.front(), flat), EPS,
                               c)
    assert not _pads(qkv, flat, 3).any()
    out = TG.ln_gdfn_ref(xf, TB.pad_gdfn_params(p.gdfn(), flat), EPS, c)
    assert not _pads(out, flat).any()

    att = TA.attn_layout(c, heads)
    qkv = TW.pad_channels(TB.reference_front(x, p.front(), EPS), att, 3)
    gram, ss = TA.attn_acc_ref(qkv, heads)
    assert not _pads(ss, att).any()
    at = TA.finalize_at(*TW.real_stats(gram, ss, att), p.temperature, bf)
    d = att.chp - att.ch
    at = torch.nn.functional.pad(at, (0, d, 0, d))
    wp = TW.pad_channels(TW.pad_channels(p.proj_w, att, dim=0), att, dim=1)
    out = TA.attn_apply_ref(qkv, TW.pad_channels(x, att), at, wp,
                            TW.pad_channels(p.proj_b, att, dim=0))
    assert not _pads(out, att).any()

    dp = _drs_params(c, heads, seed=c)
    dpp = TD.pad_drs_params(dp, lay)
    v, gram, ss = TB.block_front(xp, dpp.front(), heads, EPS, c)
    g, s = TW.real_stats(gram, ss, lay)
    atw = TW.pad_square(TD.tksa_finalize(g, s, dp.temperature, dp.mix,
                                         dp.proj_w, bf), lay)
    assert not _pads(TD.drs_apply_msfn(v, xp, atw, dpp, EPS, c), lay).any()


@pytest.mark.parametrize("c", [8, 24, 40])
def test_pads_stay_zero_through_the_padded_mefc_step(c):
    steps, weights = _steps(c, 1, seed=c)
    lay = TF.mefc_layout(c)
    assert lay.padded and lay.cp <= 128
    x = TW.pad_channels(_x(c, seed=2, dtype=torch.bfloat16).abs(), lay)
    m = TW.pad_square(TF.fold_step(steps[0], weights[:, 0].to(torch.bfloat16),
                                   torch.bfloat16), lay)
    out = TF.mefc_step(x, TF.pad_step_params(steps[0], lay), m)
    assert out.shape == x.shape and not _pads(out, lay).any()


# ------------------------------------- padded path == unpadded plain path ---

def _plain_pair(x, p, heads, gate=None):
    """The pair's passes at the real width, unpadded (the plain versions
    take any width on the CPU)."""
    v, gram, ss = TB.block_front_ref(x, p.front(), heads, EPS)
    atw = TB.finalize(gram, ss, p.temperature, p.proj_w, x.dtype, gate)
    return TB.block_apply_gdfn_ref(v, x, atw, p, EPS)


@pytest.mark.parametrize("c,heads", SHAPES)
def test_padded_path_equals_the_unpadded_plain_path_fp32(c, heads):
    p = _block_params(c, heads, seed=10 + c)
    x = _x(c, seed=3)

    def close(got, want):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)

    close(TB.fused_block(x, p, heads, EPS), _plain_pair(x, p, heads))
    gate = torch.rand(2, c, generator=torch.Generator().manual_seed(4))
    temp = 0.5 + torch.rand(2, heads, generator=torch.Generator().manual_seed(5))
    pg = p._replace(temperature=temp)
    close(TB.fused_block(x, pg, heads, EPS, gate),
          _plain_pair(x, pg, heads, gate))

    qkv = TM.ln_qkv_dwconv(x, p.front(), EPS)
    close(qkv, TM.ln_qkv_dwconv_ref(x, p.front(), EPS))
    gram, ss = TA.attn_acc_ref(qkv, heads)
    at = TA.finalize_at(gram, ss, p.temperature, x.dtype)
    close(TA.fused_mdta_core(qkv, x, p.temperature, p.proj_w, p.proj_b,
                             heads),
          TA.attn_apply_ref(qkv, x, at, p.proj_w, p.proj_b))
    close(TG.fused_ln_gdfn(x, p.gdfn(), EPS), TG.ln_gdfn_ref(x, p.gdfn(), EPS))

    dp = _drs_params(c, heads, seed=20 + c)
    v, gram, ss = TB.block_front_ref(x, dp.front(), heads, EPS)
    atw = TD.tksa_finalize(gram, ss, dp.temperature, dp.mix, dp.proj_w,
                           x.dtype)
    close(TD.fused_drs_block(x, dp, heads, EPS),
          TD.drs_apply_msfn_ref(v, x, atw, dp, EPS))

    steps, weights = _steps(c, 2, seed=30 + c)
    want = x.abs()
    for st, sp in enumerate(steps):
        want = TF.mefc_step_ref(want, sp, TF.fold_step(sp, weights[:, st],
                                                       x.dtype))
    close(TF.fused_mefc_steps(x.abs(), steps, weights), want)


# ------------------------------------------------------------ backwards ---

def test_backwards_save_the_real_width_inputs_and_differentiate_them():
    """The kernel APIs' RecomputeVJP backwards keep the real-width inputs
    (the padding lives inside the forward's launch) and give the gradients
    of the plain compositions at the real width."""
    c, heads = 24, 1
    p = _block_params(c, heads, seed=40)
    dp = _drs_params(c, heads, seed=41)
    steps, weights = _steps(c, 1, seed=42)
    x = _x(c, seed=43)
    calls = [
        (lambda t: TB.fused_block(t, p, heads, EPS),
         lambda t: TB.reference_block(t, p, heads, EPS)),
        (lambda t: TM.ln_qkv_dwconv(t, p.front(), EPS),
         lambda t: TB.reference_front(t, p.front(), EPS)),
        (lambda t: TG.fused_ln_gdfn(t, p.gdfn(), EPS),
         lambda t: TB.reference_ln_gdfn(t, p.gdfn(), EPS)),
        (lambda t: TA.fused_mdta_core(torch.cat([t, t, t], -1), t,
                                      p.temperature, p.proj_w, p.proj_b,
                                      heads),
         lambda t: TB.reference_core(torch.cat([t, t, t], -1), t,
                                     p.temperature, p.proj_w, p.proj_b,
                                     heads)),
        (lambda t: TD.fused_drs_block(t, dp, heads, EPS),
         lambda t: TD.reference_drs_block(t, dp, heads, EPS)),
        (lambda t: TF.fused_mefc_steps(t.abs(), steps, weights),
         lambda t: TF.reference_steps(t.abs(), steps, weights)),
    ]
    for api, reference in calls:
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t

        leaf = x.clone().requires_grad_()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = api(leaf)
        # x itself, and no tensor of the padded space (32 a head: 32, 96
        # for q|k|v, 256 for the concat 1x1's 8 slots)
        assert x.shape in saved and not any(
            d in (32, 96, 256) for s in saved for d in s), saved
        (got,) = torch.autograd.grad(out.sum(), leaf)
        ref_leaf = x.clone().requires_grad_()
        (want,) = torch.autograd.grad(reference(ref_leaf).sum(), ref_leaf)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


# ----------------------------------------------------------- whole model ---

def test_restormer_dim24_fused_block_matches_jax_interpret(monkeypatch):
    cfg = dict(dim=24, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
               heads=(1, 2, 4, 8), ffn_expansion_factor=2.66,
               fused_block=True)
    rng = np.random.default_rng(60)
    x = rng.random((1, 32, 32, 3), dtype=np.float32)
    jnet = JRestormer(**cfg, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]

    def seeded(tree, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = seeded(v, k)
                continue
            z = rng.standard_normal(v.shape).astype(np.float32)
            if k == "kernel":
                out[k] = z / np.sqrt(np.prod(v.shape[:-1]))
            elif k == "temperature" or (parent == "body" and k == "weight"):
                out[k] = 1.0 + 0.2 * z
            else:
                out[k] = 0.2 * z
        return out

    params = seeded(shapes)
    monkeypatch.setattr(JK, "_INTERPRET", True)
    want = np.asarray(jax.jit(lambda p, xx: jnet.apply({"params": p}, xx))(
        params, jnp.asarray(x)))
    tnet = get_model("restormer", **cfg, dtype=torch.bfloat16).eval()
    tnet.load_state_dict(state_dict_from_jax(params, tnet.state_dict()),
                         strict=True)
    assert not any(m.kernel_misfits() for m in tnet.modules()
                   if hasattr(m, "kernel_misfits"))
    calls = []
    real = TB.block_front_ref

    def spy(x, *a, **k):
        calls.append(x.shape[-1])
        return real(x, *a, **k)

    monkeypatch.setattr(TB, "block_front_ref", spy)
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got = got.permute(0, 2, 3, 1).numpy()
    # the blocks with 24-wide heads ran the pair in K1's padded layout (24
    # -> 32 a head); decoder level 1 and the refinement, 48 in one head, as
    # they are
    assert sorted(set(calls)) == [32, 48, 64, 128, 256], calls
    assert np.isfinite(got).all()
    diff, scale = np.abs(got - want), np.abs(want).max()
    assert diff.max() < 0.05 * scale and diff.mean() < 0.01 * scale, (
        diff.max(), diff.mean(), scale)
