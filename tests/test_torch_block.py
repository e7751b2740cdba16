"""The port's whole-block kernel pair (image_restoration_tpu_torch.kernels.block)
against the JAX package's ``block_pallas``.

* ``reference_block`` vs JAX ``_reference_block``: the plain composition of
  the block, fp32, rtol=1e-4, atol=1e-5.
* ``fused_block`` on the CPU (the kernels' plain versions plus the finalize)
  vs JAX ``block_pallas._forward`` running both Pallas kernels in interpret
  mode, bf16, rtol=atol=5e-2 (the tolerance of test_fused_block_pipe.py:
  bf16 rounds in the same places, but products are summed in other orders).
* fp32: the plain passes round nowhere, so the fused composition must equal
  the plain block (rtol=1e-4, atol=1e-5).

The kernels themselves run only on the card: tests/test_torch_block_cuda.py
holds them to the plain versions tested here.

Inputs and weights are made with numpy from a seed, c in {48, 96}, heads in
{1, 2}, both LN types, at 24x20 like test_fused_block_pipe.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.kernels import block_pallas as JK
from image_restoration_tpu_torch.kernels import block as TK

H, W, EPS = 24, 20, 1e-5
CASES = [(c, heads, ln) for c in (48, 96) for heads in (1, 2)
         for ln in ("WithBias", "BiasFree")]


def _jax_params(rng, c, heads, ln_type):
    """JAX 17-tuple; Restormer-base's layout for WithBias (bias-free convs),
    every conv bias present for BiasFree, so both bias paths are covered."""
    hidden = int(c * 2.66)
    conv_bias = ln_type == "BiasFree"

    def mk(*shape, sc=0.05):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    cb = (lambda *s: mk(*s, sc=0.02)) if conv_bias else (lambda *s: None)
    lnb = (lambda: mk(c, sc=0.1)) if ln_type == "WithBias" else (lambda: None)
    return (
        mk(c, sc=0.1) + 1.0, lnb(),               # ln1
        mk(c, 1, 1, 3 * c), cb(3 * c),            # qkv 1x1 (HWIO)
        mk(3, 3, 1, 3 * c, sc=0.3), cb(3 * c),    # qkv depthwise
        mk(heads, 1, 1, sc=0.3) + 1.0,            # temperature
        mk(c, 1, 1, c), cb(c),                    # project_out
        mk(c, sc=0.1) + 1.0, lnb(),               # ln2
        mk(c, 1, 1, 2 * hidden), cb(2 * hidden),  # ffn project_in
        mk(3, 3, 1, 2 * hidden, sc=0.3), cb(2 * hidden),  # ffn depthwise
        mk(hidden, 1, 1, c), cb(c),               # ffn project_out
    )


def _port_params(jp, c):
    """The same weights in torch layout (OIHW) as a BlockParams."""
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    dense = lambda a: t(a.reshape(-1, a.shape[-1]).T[:, :, None, None])  # noqa: E731
    dw = lambda a: t(a.transpose(3, 2, 0, 1))  # noqa: E731
    (ln1w, ln1b, wq, bq, wd, bd, temp, wp, bp, ln2w, ln2b, wi, bi, wd2, bd2,
     wo, bo) = jp
    return TK.BlockParams(t(ln1w), t(ln1b), dense(wq), t(bq), dw(wd), t(bd),
                          t(temp), dense(wp), t(bp), t(ln2w), t(ln2b),
                          dense(wi), t(bi), dw(wd2), t(bd2), dense(wo), t(bo))


def _jnp(jp):
    return tuple(None if a is None else jnp.asarray(a) for a in jp)


def _x(rng, c, scale=1.0):
    return (rng.standard_normal((1, H, W, c)) * scale).astype(np.float32)


@pytest.mark.parametrize("c,heads,ln_type", CASES)
def test_reference_block_matches_jax(c, heads, ln_type):
    rng = np.random.default_rng(c + heads)
    jp = _jax_params(rng, c, heads, ln_type)
    x = _x(rng, c)
    with jax.default_matmul_precision("highest"):
        want = JK._reference_block(jnp.asarray(x), _jnp(jp), heads, ln_type, EPS)
    got = TK.reference_block(torch.from_numpy(x), _port_params(jp, c), heads, EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("c,heads,ln_type", CASES)
def test_fused_block_matches_jax_interpret(monkeypatch, c, heads, ln_type):
    rng = np.random.default_rng(10 + c + heads)
    jp = _jax_params(rng, c, heads, ln_type)
    x = jnp.asarray(_x(rng, c, 0.5), jnp.bfloat16)
    monkeypatch.setattr(JK, "_INTERPRET", True)
    cfg = (c, W, heads, ln_type, EPS)
    want = JK.canvas_unpad(JK._forward(JK.canvas_pad(x), _jnp(jp), cfg), W, c)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = TK.fused_block(xt, _port_params(jp, c), heads, EPS)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("c,heads,ln_type", CASES[::3])
def test_fused_block_fp32_equals_reference_block(c, heads, ln_type):
    rng = np.random.default_rng(20 + c)
    p = _port_params(_jax_params(rng, c, heads, ln_type), c)
    x = torch.from_numpy(_x(rng, c))
    np.testing.assert_allclose(TK.fused_block(x, p, heads, EPS).numpy(),
                               TK.reference_block(x, p, heads, EPS).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_cpu_wrappers_use_plain_versions_without_counting():
    rng = np.random.default_rng(3)
    p = _port_params(_jax_params(rng, 48, 1, "WithBias"), 48)
    x = torch.from_numpy(_x(rng, 48)).to(torch.bfloat16)
    before = (TK.block_front.launches, TK.block_apply_gdfn.launches)
    v, gram, ss = TK.block_front(x, p, 1)
    rv, rgram, rss = TK.block_front_ref(x, p, 1)
    assert torch.equal(v, rv) and torch.equal(gram, rgram) and torch.equal(ss, rss)
    atw = TK.finalize(gram, ss, p.temperature, p.proj_w, x.dtype)
    assert atw.shape == (1, 48, 48) and atw.dtype == torch.bfloat16
    assert torch.equal(TK.block_apply_gdfn(v, x, atw, p),
                       TK.block_apply_gdfn_ref(v, x, atw, p))
    assert (TK.block_front.launches, TK.block_apply_gdfn.launches) == before



def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel path, whose checks refuse what is not a CUDA tensor."""
    rng = np.random.default_rng(4)
    p = _port_params(_jax_params(rng, 48, 1, "WithBias"), 48)
    x = torch.zeros((1, H, W, 48), dtype=torch.bfloat16, device="meta")
    atw = torch.zeros((1, 48, 48), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TK.block_front(x, p, 1)
    with pytest.raises(ValueError, match="CUDA"):
        TK.block_apply_gdfn(x, x, atw, p)
