"""The port's gated linear attention (``ops/gla.py``) against the JAX
package's, and its fix of JAX's intra-chunk overflow.

Inputs are seeded numpy arrays: q, k, v standard normal, the gates
``logsigmoid(3 z) / 16`` (decays of up to ~0.7 a token), given to both
packages in fp32; the JAX side is jitted at "highest" matmul precision.

* ``recurrent_gla``, ``chunk_gla`` and ``bidirectional_gla`` at N = 37
  (one chunk of 37), 64 (one full chunk) and 130 (three chunks, the last
  padded): within atol = 1e-5 x max|output| of JAX's (fp32 sums in other
  orders; seen: ~3e-7 relative). ``chunk_gla``'s input gradients against
  ``jax.grad`` of JAX's ``chunk_gla`` at N = 130, the same tolerance
  relative to each gradient's largest entry.
* The gate finding: JAX's ``chunk_gla`` takes ``exp(G_i - G_j)`` over the
  whole chunk and masks after the einsum, so with gate logits of -40
  (-2.5 a token after ``logsigmoid / 16``) the exponent above the diagonal
  passes fp32's range within a 64-token chunk and inf * 0 gives NaN. One
  head at gate logit 0 and one at -40: JAX's output is non-finite in the
  second head only; the port's is finite everywhere, equals the port's
  ``recurrent_gla`` (atol 1e-5 x max) and JAX's ``chunk_gla`` wherever
  JAX's is finite (same tolerance), and its gradients are finite and equal
  the recurrence's (autograd through the loop; atol 1e-5 x max).
* bf16 inputs give a bf16 output, the fp32 math's rounded (JAX's rule):
  the port's bf16 output equals its own fp32 output of the same rounded
  inputs rounded once to bf16 (exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import ATOL

from image_restoration_tpu.ops import gla as J
from image_restoration_tpu_torch.ops import gla as T


def _inputs(rng, n, b=2, h=2, dk=8, dv=12, gate=None):
    q, k = (rng.standard_normal((b, h, n, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, n, dv)).astype(np.float32)
    z = (3 * rng.standard_normal((b, h, n, dk)) if gate is None
         else np.broadcast_to(np.asarray(gate, np.float64)[None, :, None,
                                                           None],
                              (b, h, n, dk)))
    g = (-np.logaddexp(0.0, -z) / 16).astype(np.float32)  # logsigmoid / 16
    return q, k, v, g


def _jax(fn, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(fn)(*args))


def _close(got, want, scale=None):
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=ATOL * scale)


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("n", [37, 64, 130])
@pytest.mark.parametrize("name", ["recurrent_gla", "chunk_gla",
                                  "bidirectional_gla"])
def test_gla_matches_jax(name, n):
    rng = np.random.default_rng(n)
    q, k, v, g = _inputs(rng, n)
    args = (q, k, v, g)
    if name == "bidirectional_gla":
        args += (_inputs(rng, n)[3],)
    want = _jax(getattr(J, name), *args)
    with torch.no_grad():
        got = getattr(T, name)(*_torch(*args))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


def test_chunk_gla_gradients_match_jax():
    rng = np.random.default_rng(5)
    args = _inputs(rng, 130)
    w = rng.standard_normal((2, 2, 130, 12)).astype(np.float32)

    def loss(*a):
        return jnp.sum(J.chunk_gla(*a) * w)

    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*args)
    ts = _torch(*args, grad=True)
    (T.chunk_gla(*ts) * torch.from_numpy(w)).sum().backward()
    for t, gw in zip(ts, want):
        _close(t.grad, np.asarray(gw))


def test_gate_minus_40_is_finite_and_equals_the_recurrence():
    rng = np.random.default_rng(6)
    args = _inputs(rng, 64, gate=[0.0, -40.0])
    want = _jax(J.chunk_gla, *args)
    assert np.isfinite(want[:, 0]).all() and not np.isfinite(want[:, 1]).all()

    ts = _torch(*args, grad=True)
    got = T.chunk_gla(*ts)
    w = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    (got * w).sum().backward()
    rs = _torch(*args, grad=True)
    ref = T.recurrent_gla(*rs)
    (ref * w).sum().backward()

    assert torch.isfinite(got).all()
    _close(got.detach(), ref.detach().numpy())
    ok = np.isfinite(want)
    _close(got.detach().numpy()[ok], want[ok], np.abs(want[ok]).max())
    for t, r in zip(ts, rs):
        assert torch.isfinite(t.grad).all()
        _close(t.grad, r.grad.numpy())


def test_bf16_inputs_round_the_fp32_result():
    rng = np.random.default_rng(7)
    q, k, v, g = _torch(*_inputs(rng, 70))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    got = T.chunk_gla(q, k, v, g)
    want = T.chunk_gla(q.float(), k.float(), v.float(), g).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
