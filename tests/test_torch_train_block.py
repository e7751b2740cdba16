"""The gradient of the port's ``fused_block`` (a ``torch.autograd.Function``
in ``kernels/block.py``) against ``jax.vjp`` of the JAX ``fused_block``
custom VJP (``block_pallas.py:634-676``).

JAX runs both Pallas passes in interpret mode (``block_pallas._INTERPRET``,
as tests/test_fused_block_pipe.py does) for the forward; its ``_bwd``
differentiates ``_reference_block`` recomputed from the saved input. The
port's forward runs the plain passes on these CPU tensors, and its backward
differentiates ``reference_block`` the same way. In fp32, under a fixed
linear loss sum(out * g), the gradients of x, every parameter and the gate
must agree at rtol 1e-4 and atol 1e-5 x the largest |gradient| of that
tensor: each is a sum over every pixel of the batch, taken in another
order by XLA's and torch's conv backward.

Covered: WithBias (Restormer-base's bias-free convs) and BiasFree (every
conv bias), without a gate and with CG-IR's (B, C) output gate and
per-sample (B, heads) temperature.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_block import _jax_params, _jnp, _port_params

from image_restoration_tpu.kernels import block_pallas as JK
from image_restoration_tpu_torch.kernels import block as TK

B, H, W, EPS = 2, 8, 12, 1e-5
CASES = [(48, 1, "WithBias", False), (32, 2, "BiasFree", False),
         (48, 1, "BiasFree", True), (32, 2, "WithBias", True)]


def _close(got, want):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("c,heads,ln_type,gated", CASES)
def test_fused_block_grads_match_jax_vjp(monkeypatch, c, heads, ln_type,
                                         gated):
    rng = np.random.default_rng(c + 10 * heads + gated)
    jp = list(_jax_params(rng, c, heads, ln_type))
    x = (rng.standard_normal((B, H, W, c)) * 0.5).astype(np.float32)
    g = rng.standard_normal((B, H, W, c)).astype(np.float32)
    gate = None
    if gated:
        jp[6] = np.exp(0.3 * rng.standard_normal((B, heads))).astype(np.float32)
        gate = (1 / (1 + np.exp(-rng.standard_normal((B, c))))).astype(np.float32)

    monkeypatch.setattr(JK, "_INTERPRET", True)
    cfg = (c, W, heads, ln_type, EPS)
    params = _jnp(jp)
    if gated:
        fn = lambda xc, pp, gg: JK.fused_block(xc, pp, cfg, gg)  # noqa: E731
        args = (JK.canvas_pad(jnp.asarray(x)), params, jnp.asarray(gate))
    else:
        fn = lambda xc, pp: JK.fused_block(xc, pp, cfg)  # noqa: E731
        args = (JK.canvas_pad(jnp.asarray(x)), params)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(fn, *args)
        grads = vjp(JK.canvas_pad(jnp.asarray(g)))

    p = _port_params(tuple(jp), c)
    p = TK.BlockParams(*(None if t is None else t.requires_grad_()
                         for t in p))
    xt = torch.from_numpy(x).requires_grad_()
    gt = None if gate is None else torch.from_numpy(gate).requires_grad_()
    got = TK.fused_block(xt, p, heads, EPS, gate=gt)
    assert type(got.grad_fn).__name__ == "_FusedBlockBackward"
    assert got.shape == x.shape and out.shape[:2] == x.shape[:2]
    leaves = [xt] + [t for t in p if t is not None] + ([gt] if gated else [])
    got_grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))

    _close(got_grads[0], JK.canvas_unpad(grads[0], W, c))
    want_p = _port_params(tuple(None if t is None else np.asarray(t)
                                for t in grads[1]), c)
    want_p = [t for t in want_p if t is not None]
    assert len(want_p) == len(leaves) - 1 - gated
    for name_grad, want in zip(got_grads[1:], want_p):
        _close(name_grad, want.numpy())
    if gated:
        _close(got_grads[-1], grads[2])


def test_fused_block_backward_recomputes_without_the_passes(monkeypatch):
    """The backward runs ``reference_block``: the forward's passes (here
    their plain versions, counted by call) run once, in the forward."""
    rng = np.random.default_rng(5)
    p = _port_params(_jax_params(rng, 32, 2, "WithBias"), 32)
    p = p._replace(qkv_w=p.qkv_w.requires_grad_())
    x = torch.from_numpy(rng.standard_normal((1, H, W, 32)).astype(np.float32))
    calls = []
    real = TK.block_front_ref

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TK, "block_front_ref", counting)
    TK.fused_block(x, p, 2, EPS).sum().backward()
    assert calls == [1]
    assert p.qkv_w.grad is not None and torch.isfinite(p.qkv_w.grad).all()
    ref = torch.autograd.grad(TK.reference_block(x, p, 2, EPS).sum(),
                              p.qkv_w)[0]
    torch.testing.assert_close(p.qkv_w.grad, ref, rtol=0, atol=0)


def test_fused_block_without_grad_is_the_passes():
    """Serving is unchanged: with nothing to differentiate, no Function."""
    rng = np.random.default_rng(6)
    p = _port_params(_jax_params(rng, 32, 2, "WithBias"), 32)
    x = torch.from_numpy(rng.standard_normal((1, H, W, 32)).astype(np.float32))
    out = TK.fused_block(x, p, 2, EPS)
    assert out.grad_fn is None
    with torch.no_grad():
        xg = x.clone().requires_grad_()
        assert TK.fused_block(xg, p, 2, EPS).grad_fn is None
