"""The port's MEFC step kernel (image_restoration_tpu_torch.kernels.mefc)
against the JAX package's ``mefc_pallas``.

* ``reference_steps`` vs JAX ``_reference_steps``: the plain composition of
  four op-mixture steps, fp32, rtol=1e-4, atol=1e-5.
* ``fused_mefc_steps`` on the CPU (the fold and K8's plain version) vs JAX
  ``mefc_pallas._forward`` running the Pallas step kernel in interpret
  mode, bf16, rtol=atol=5e-2 (the JAX tests' own bound,
  test_mefc_fused.py).
* The same in fp32 against the JAX kernel with its ``_F32_MIX`` on, which
  makes it round nowhere: rtol=1e-4, atol=1e-5, after
  test_mefc_fused.py:54-70. At this bound an index or mask bug shows (the
  unmasked SepConv t1 halo was one); bf16 tolerances absorb such bugs.

c 8 and 16 at 16x12 (the JAX tests' size) and 8x5, where the 7x7 taps
reach past the image on every side; c 8 and 24 run padded to 16 and 32
(``kernels/mefc.py`` ``mefc_layout``: M folded at the real width, zero
rows and columns at the pads). The kernel itself runs only on the
card: tests/test_torch_drs_cuda.py holds it to the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.kernels import mefc_pallas as JK
from image_restoration_tpu_torch.kernels import mefc as TK

STEPS = 4


def _jax_steps(rng, c):
    """Four steps' raw params in the JAX layout (HWIO), bias-free."""
    def mk(*shape, sc):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    one = lambda: mk(1, 1, c, c, sc=c ** -0.5)  # noqa: E731
    return [dict(
        sep=[dict(dwa=mk(k, k, 1, c, sc=1.0 / k), w1=one(),
                  dwb=mk(k, k, 1, c, sc=1.0 / k), w2=one())
             for k in TK.SEP_KS],
        dil=[dict(dw=mk(k, k, 1, c, sc=1.0 / k), w1=one()) for k in TK.DIL_KS],
        wcat=mk(1, 1, 8 * c, c, sc=(8 * c) ** -0.5)) for _ in range(STEPS)]


def _port_steps(raw):
    conv = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))  # noqa: E731
    return [TK.StepParams(
        [conv(s["dwa"]) for s in sp["sep"]], [conv(s["w1"]) for s in sp["sep"]],
        [conv(s["dwb"]) for s in sp["sep"]], [conv(s["w2"]) for s in sp["sep"]],
        [conv(d["dw"]) for d in sp["dil"]], [conv(d["w1"]) for d in sp["dil"]],
        conv(sp["wcat"])) for sp in raw]


def _inputs(c, h, w, seed):
    rng = np.random.default_rng(seed)
    raw = _jax_steps(rng, c)
    x = np.abs(rng.standard_normal((2, h, w, c))).astype(np.float32) * 0.5
    logits = rng.standard_normal((2, STEPS, TK.NUM_OPS)).astype(np.float32)
    weights = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return raw, x, weights


def _jax_forward(x, raw, weights):
    return np.asarray(JK._forward(jnp.asarray(x), jax.tree.map(jnp.asarray, raw),
                                  jnp.asarray(weights), interpret=True),
                      np.float32)


@pytest.mark.parametrize("c,h,w", [(8, 16, 12), (16, 8, 5)])
def test_reference_steps_match_jax(c, h, w):
    raw, x, weights = _inputs(c, h, w, seed=c)
    with jax.default_matmul_precision("highest"):
        want = JK._reference_steps(jnp.asarray(x), jax.tree.map(jnp.asarray, raw),
                                   jnp.asarray(weights))
    got = TK.reference_steps(torch.from_numpy(x), _port_steps(raw),
                             torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_fused_steps_match_jax_interpret_bf16():
    raw, x, weights = _inputs(8, 16, 12, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(weights, jnp.bfloat16)
    want = _jax_forward(xb, raw, wb)
    got = TK.fused_mefc_steps(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
        _port_steps(raw),
        torch.from_numpy(np.asarray(wb, np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


def test_fused_steps_at_c24_match_jax_interpret_bf16():
    """C 24, which K8 takes padded to 32, in bf16 against the JAX kernel on
    its lane-padded canvas."""
    raw, x, weights = _inputs(24, 8, 5, seed=4)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(weights, jnp.bfloat16)
    want = _jax_forward(xb, raw, wb)
    got = TK.fused_mefc_steps(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
        _port_steps(raw),
        torch.from_numpy(np.asarray(wb, np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("c,h,w", [(8, 16, 12), (16, 8, 5), (24, 8, 5)])
def test_fused_steps_fp32_match_jax_kernel_strictly(monkeypatch, c, h, w):
    raw, x, weights = _inputs(c, h, w, seed=2 + c)
    monkeypatch.setattr(JK, "_F32_MIX", True)
    with jax.default_matmul_precision("highest"):
        want = _jax_forward(x, raw, weights)
    got = TK.fused_mefc_steps(torch.from_numpy(x), _port_steps(raw),
                              torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_cpu_wrapper_uses_plain_version_without_counting():
    raw, x, weights = _inputs(8, 16, 12, seed=3)
    sp = _port_steps(raw)[0]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    m = TK.fold_step(sp, torch.from_numpy(weights[:, 0]).to(torch.bfloat16),
                     torch.bfloat16)
    assert m.shape == (2, 8, 8, 8) and m.dtype == torch.bfloat16
    before = TK.mefc_step.launches
    assert torch.equal(TK.mefc_step(xt, sp, m), TK.mefc_step_ref(xt, sp, m))
    assert TK.mefc_step.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        TK.mefc_step(xt.to("meta"), sp, m.to("meta"))
