"""The three-kernel Restormer block's plain versions against the JAX
package's kernels, and the Restormer in every kernel-flag combination
against the JAX Restormer with the same flags.

On the CPU the JAX kernels return their plain-XLA compositions
(``mdta_pallas._reference``, ``attn_core_pallas._reference_core``,
``gdfn_pallas._reference_ln_gdfn``); the port's wrappers, given CPU
tensors, run their plain versions. Both get the same numpy-seeded weights
and inputs.

* ``ln_qkv_dwconv_ref`` against ``fused_ln_qkv_dwconv`` and against
  ``fused_ln_qkv_dwconv_split`` sliced at [i * cps, i * cps + C];
  ``fused_mdta_core`` (the chain of the plain versions) against the JAX
  ``fused_mdta_core`` on the split map; ``ln_gdfn_ref`` against
  ``fused_ln_gdfn``. C in {16, 32}, heads in {1, 2}, 9x20 (an odd height, a
  width that is not a multiple of 16), WithBias and BiasFree, with and
  without conv biases; and ``WIDTHS``, head widths 24 and 80 (C 24 and 80
  in one head, 48 in two), which the kernel APIs run padded
  (``kernels/widths.py``: K3 and K4 to a multiple of 16, K5 and K6 each
  head to 32 or 96). fp32: rtol=1e-4, atol=1e-5 (the same math, sums in
  other orders).
* bf16: the JAX compositions round after every conv, the port's plain
  versions where the CUDA kernels round, so the two differ by a few bf16
  steps: max difference 3% of max|JAX output| (a bf16 step is 0.4%).
* Restormer at dim 16, blocks 1/1/1/1, 1 refinement block, 32x32, in the
  four combinations of ``fused_attn`` and ``fused_gdfn``, fp32, atol=1e-4
  (test_torch_restormer.py's), and the three-kernel model in bf16 with
  test_torch_restormer.py's bf16 rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.kernels import attn_core_pallas as JA
from image_restoration_tpu.kernels import gdfn_pallas as JG
from image_restoration_tpu.kernels import mdta_pallas as JM
from image_restoration_tpu.models.restormer import Restormer as JRestormer
from image_restoration_tpu_torch.kernels import attn_core as TA
from image_restoration_tpu_torch.kernels import block as TB
from image_restoration_tpu_torch.kernels import gdfn as TG
from image_restoration_tpu_torch.kernels import mdta as TM
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

H, W, EPS = 9, 20, 1e-5
CASES = [(c, heads, ln, bias) for c in (16, 32) for heads in (1, 2)
         for ln in ("WithBias", "BiasFree") for bias in (False, True)]
WIDTHS = [(24, 1, "WithBias", True), (80, 1, "BiasFree", False),
          (48, 2, "WithBias", False)]
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _weights(rng, c, heads, ln_type, bias):
    """The block's weights in the JAX layout (HWIO, the 17-tuple of
    block_pallas): LN affines near 1 and 0, conv biases when ``bias``."""
    hidden = int(c * 2.66)

    def mk(*shape, sc=0.05, base=0.0):
        return (base + sc * rng.standard_normal(shape)).astype(np.float32)

    cb = (lambda n: mk(n, sc=0.02)) if bias else (lambda n: None)
    lnb = (lambda: mk(c, sc=0.1)) if ln_type == "WithBias" else (lambda: None)
    return (mk(c, sc=0.1, base=1.0), lnb(),
            mk(1, 1, c, 3 * c, sc=c ** -0.5), cb(3 * c),
            mk(3, 3, 1, 3 * c, sc=0.3), cb(3 * c),
            mk(heads, 1, 1, sc=0.3, base=1.0),
            mk(1, 1, c, c, sc=c ** -0.5), cb(c),
            mk(c, sc=0.1, base=1.0), lnb(),
            mk(1, 1, c, 2 * hidden, sc=c ** -0.5), cb(2 * hidden),
            mk(3, 3, 1, 2 * hidden, sc=0.3), cb(2 * hidden),
            mk(1, 1, hidden, c, sc=hidden ** -0.5), cb(c))


def _port(jw):
    """The same weights in torch layout (OIHW) as a BlockParams."""
    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))

    def oihw(a):
        return t(a.transpose(3, 2, 0, 1))

    (ln1w, ln1b, wq, bq, wd, bd, temp, wp, bp, ln2w, ln2b, wi, bi, wd2, bd2,
     wo, bo) = jw
    return TB.BlockParams(t(ln1w), t(ln1b), oihw(wq), t(bq), oihw(wd), t(bd),
                          t(temp), oihw(wp), t(bp), t(ln2w), t(ln2b),
                          oihw(wi), t(bi), oihw(wd2), t(bd2), oihw(wo), t(bo))


def _j(*arrays):
    return tuple(None if a is None else jnp.asarray(a) for a in arrays)


def _case(c, heads, ln_type, bias, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    jw = _weights(rng, c, heads, ln_type, bias)
    x = rng.standard_normal((2, H, W, c)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype != np.float32 else jnp.float32)
    xt = torch.from_numpy(np.array(xj, np.float32))
    if dtype != np.float32:
        xt = xt.to(torch.bfloat16)
    return jw, _port(jw), xj, xt


def _np(t):
    return t.float().numpy()


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("c,heads,ln_type,bias", CASES + WIDTHS)
def test_ln_qkv_dwconv_matches_jax(c, heads, ln_type, bias):
    jw, p, xj, xt = _case(c, heads, ln_type, bias, seed=c + heads)
    got = _np(TM.ln_qkv_dwconv(xt, p.front(), EPS))
    params = _j(*jw[:6])
    _close(got, JM.fused_ln_qkv_dwconv(xj, params, ln_type, EPS))
    split = np.asarray(JM.fused_ln_qkv_dwconv_split(xj, params, ln_type, EPS))
    cps = split.shape[-1] // 3
    for i in range(3):
        _close(got[..., i * c:(i + 1) * c], split[..., i * cps:i * cps + c])


@pytest.mark.parametrize("c,heads,ln_type,bias", CASES + WIDTHS)
def test_fused_mdta_core_matches_jax(c, heads, ln_type, bias):
    jw, p, xj, xt = _case(c, heads, ln_type, bias, seed=10 + c + heads)
    params = _j(*jw[:6])
    split = JM.fused_ln_qkv_dwconv_split(xj, params, ln_type, EPS)
    want = JA.fused_mdta_core(split, xj, *_j(jw[6], jw[7], jw[8]), heads)
    qkv = TM.ln_qkv_dwconv(xt, p.front(), EPS)
    got = TA.fused_mdta_core(qkv, xt, p.temperature, p.proj_w, p.proj_b,
                             heads)
    _close(_np(got), want)


@pytest.mark.parametrize("c,heads,ln_type,bias", CASES + WIDTHS)
def test_ln_gdfn_matches_jax(c, heads, ln_type, bias):
    jw, p, xj, xt = _case(c, heads, ln_type, bias, seed=20 + c + heads)
    want = JG.fused_ln_gdfn(xj, _j(*jw[9:]), ln_type, EPS)
    _close(_np(TG.fused_ln_gdfn(xt, p.gdfn(), EPS)), want)


@pytest.mark.parametrize("ln_type,bias", [("WithBias", False),
                                          ("BiasFree", True)])
def test_three_kernel_block_bf16_matches_jax(ln_type, bias):
    """qkv map, attention core and LN + GDFN in bf16, each on the same
    input in both packages."""
    c, heads = 32, 2
    jw, p, xj, xt = _case(c, heads, ln_type, bias, seed=30, dtype="bf16")
    params = _j(*jw[:6])
    split = JM.fused_ln_qkv_dwconv_split(xj, params, ln_type, EPS)
    qkv = TM.ln_qkv_dwconv(xt, p.front(), EPS)
    assert qkv.dtype == torch.bfloat16
    cps = split.shape[-1] // 3
    want_qkv = np.concatenate([np.asarray(split[..., i * cps:i * cps + c],
                                          np.float32) for i in range(3)], -1)
    pairs = [(_np(qkv), want_qkv)]
    y = TA.fused_mdta_core(qkv, xt, p.temperature, p.proj_w, p.proj_b, heads)
    pairs.append((_np(y), JA.fused_mdta_core(split, xj, *_j(*jw[6:9]),
                                              heads)))
    pairs.append((_np(TG.fused_ln_gdfn(xt, p.gdfn(), EPS)),
                  JG.fused_ln_gdfn(xj, _j(*jw[9:]), ln_type, EPS)))
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() < 0.03 * np.abs(want).max()


def test_cpu_wrappers_use_plain_versions_without_counting():
    jw, p, _, xt = _case(32, 2, "WithBias", False, seed=40, dtype="bf16")
    fns = (TM.ln_qkv_dwconv, TA.attn_acc, TA.attn_apply, TG.fused_ln_gdfn)
    before = [f.launches for f in fns]
    qkv = TM.ln_qkv_dwconv(xt, p.front())
    assert torch.equal(qkv, TM.ln_qkv_dwconv_ref(xt, p.front()))
    gram, ss = TA.attn_acc(qkv, 2)
    for a, b in zip((gram, ss), TA.attn_acc_ref(qkv, 2)):
        assert torch.equal(a, b)
    at = TA.finalize_at(gram, ss, p.temperature, torch.bfloat16)
    assert at.shape == (2, 2, 16, 16) and at.dtype == torch.bfloat16
    assert torch.equal(TA.attn_apply(qkv, xt, at, p.proj_w, p.proj_b),
                       TA.attn_apply_ref(qkv, xt, at, p.proj_w, p.proj_b))
    assert torch.equal(TG.fused_ln_gdfn(xt, p.gdfn()),
                       TG.ln_gdfn_ref(xt, p.gdfn()))
    assert [f.launches for f in fns] == before


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel path, whose checks refuse what is not a CUDA tensor."""
    _, p, _, _ = _case(32, 2, "WithBias", False, seed=41)
    x = torch.zeros((1, H, W, 32), dtype=torch.bfloat16, device="meta")
    qkv = torch.zeros((1, H, W, 96), dtype=torch.bfloat16, device="meta")
    at = torch.zeros((1, 2, 16, 16), dtype=torch.bfloat16, device="meta")
    for call in (lambda: TM.ln_qkv_dwconv(x, p.front()),
                 lambda: TA.attn_acc(qkv, 2),
                 lambda: TA.attn_apply(qkv, x, at, p.proj_w, p.proj_b),
                 lambda: TG.fused_ln_gdfn(x, p.gdfn())):
        with pytest.raises(ValueError, match="CUDA"):
            call()


# ----------------------------------------------------------- whole model ---

SMALL = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
             heads=(1, 2, 4, 8), ffn_expansion_factor=2.66)


def _seeded_tree(jnet, x, rng):
    """The JAX model's param tree filled from ``rng``: conv kernels at the
    fan-in scale, LN weights and temperatures near 1, the rest near 0."""
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x)["params"]

    def walk(tree, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
                continue
            z = rng.standard_normal(v.shape).astype(np.float32)
            if k == "kernel":
                out[k] = z / np.sqrt(np.prod(v.shape[:-1]))
            elif k == "temperature" or (parent == "body" and k == "weight"):
                out[k] = 1.0 + 0.2 * z
            else:
                out[k] = 0.2 * z
        return out
    return walk(shapes)


def _models(flags, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((1, 32, 32, 3), dtype=np.float32)
    jnet = JRestormer(**SMALL, **flags,
                      dtype=None if dtype == "fp32" else jnp.bfloat16)
    params = _seeded_tree(jnet, jnp.asarray(x), rng)
    tnet = get_model("restormer", **SMALL, **flags,
                     dtype=None if dtype == "fp32" else torch.bfloat16).eval()
    tnet.load_state_dict(state_dict_from_jax(params, tnet.state_dict()),
                         strict=True)
    want = np.asarray(jax.jit(lambda p, xx: jnet.apply({"params": p}, xx))(
        params, jnp.asarray(x)))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert got.dtype == torch.float32
    return got.permute(0, 2, 3, 1).numpy(), want


@pytest.mark.parametrize("fused_attn,fused_gdfn", [(False, False),
                                                   (True, False),
                                                   (False, True),
                                                   (True, True)])
def test_restormer_kernel_flags_match_jax(fused_attn, fused_gdfn):
    got, want = _models(dict(fused_attn=fused_attn, fused_gdfn=fused_gdfn),
                        "fp32", seed=50)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_restormer_three_kernel_bf16_matches_jax():
    got, want = _models(dict(fused_attn=True, fused_gdfn=True), "bf16",
                        seed=51)
    assert np.isfinite(got).all()
    diff, scale = np.abs(got - want), np.abs(want).max()
    assert diff.max() < 0.05 * scale and diff.mean() < 0.01 * scale, (
        diff.max(), diff.mean(), scale)


@pytest.mark.parametrize("fused_block,expected", [
    (True, []),
    (False, ["ln_qkv_dwconv", "fused_mdta_core", "fused_ln_gdfn"])])
def test_fused_block_wins_over_the_three_kernel_flags(monkeypatch,
                                                      fused_block, expected):
    """As in the JAX model, ``fused_block`` decides the block's path."""
    from image_restoration_tpu_torch.models import restormer as R

    calls = []
    for name in ("ln_qkv_dwconv", "fused_mdta_core", "fused_ln_gdfn"):
        def spy(*a, _orig=getattr(R, name), _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(R, name, spy)
    net = get_model("restormer", **SMALL, fused_block=fused_block,
                    fused_attn=True, fused_gdfn=True).eval()
    with torch.inference_mode():
        net.encoder_level1[0](torch.zeros(1, 16, 8, 8))
    assert calls == expected
