"""The gradients of the port's kernel APIs (``torch.autograd.Function``s
with the JAX custom VJPs' semantics) against ``jax.vjp`` of the JAX custom
VJPs, on the CPU in fp32.

Every JAX kernel API on the CPU runs its reference composition forward and
its ``_bwd`` (the custom VJP: ``jax.vjp`` of the same composition at the
saved input and parameters) backward, so ``jax.vjp`` of the API itself is
what a training step on the JAX side differentiates. The port's APIs, given
CPU tensors, run the kernels' plain versions forward and differentiate
their recomputed references backward (``kernels/block.py``
``RecomputeVJP``; SKA's ``ops/ska.py`` ``ska_bwd_plain``). Under a fixed
linear loss sum(out * g), the gradients of the input and of every
parameter must agree at rtol 1e-4 and atol 1e-5 x the largest |gradient|
of that tensor: each is a sum over the pixels of the batch, taken in
another order by XLA's and torch's conv backward.

* ``ln_qkv_dwconv`` (K4) vs ``mdta_pallas.fused_ln_qkv_dwconv``;
  ``fused_mdta_core`` (K5, finalize, K6) vs ``attn_core_pallas
  .fused_mdta_core`` on the slot-padded map (with and without b_proj:
  None has no gradient); ``fused_ln_gdfn`` (K3) vs
  ``gdfn_pallas.fused_ln_gdfn``. C 16 and 32, 1 and 2 heads, both LN
  types, with and without conv biases, 9x20.
* ``fused_drs_block`` (K1, TKSA finalize, K7) vs
  ``drs_block_pallas.fused_drs_block`` on the border-4 canvas, an odd
  hidden width (the group pairing d3 with d5) and every conv bias.
* ``fused_mefc_steps`` (K8 per step) vs ``mefc_pallas.fused_mefc_steps``:
  x, the step's parameters and the (B, steps, 8) weights.
The JAX side's VJPs are compiled (``_jit_vjp``), which is faster here
than running them op by op.
* ``ska`` (K9 and its two backward kernels) vs ``ska_pallas.ska_pallas``;
  ``ska_bwd_plain`` vs ``_ska_bwd`` with C > wc (the c -> w[c mod wc]
  tile) and k 5: bit-equal, the same fp32 products summed in the same
  order.
* Each API's backward recomputes without running the forward's passes
  again, and with nothing to differentiate the call is the forward itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_drs_kernels import _jax_params as _drs_jax_params
from test_torch_drs_kernels import _jnp as _drs_jnp
from test_torch_drs_kernels import _port_params as _drs_port_params
from test_torch_drs_mefc import _jax_steps, _port_steps
from test_torch_fused_ops import _j, _port, _weights

from image_restoration_tpu.kernels import attn_core_pallas as JA
from image_restoration_tpu.kernels import drs_block_pallas as JD
from image_restoration_tpu.kernels import gdfn_pallas as JG
from image_restoration_tpu.kernels import mdta_pallas as JM
from image_restoration_tpu.kernels import mefc_pallas as JF
from image_restoration_tpu.kernels import ska_pallas as JS
from image_restoration_tpu_torch.kernels import attn_core as TA
from image_restoration_tpu_torch.kernels import block as TB
from image_restoration_tpu_torch.kernels import drs_block as TD
from image_restoration_tpu_torch.kernels import gdfn as TG
from image_restoration_tpu_torch.kernels import mdta as TM
from image_restoration_tpu_torch.kernels import mefc as TF
from image_restoration_tpu_torch.kernels import ska as TS
from image_restoration_tpu_torch.ops.ska import ska_bwd_plain

H, W, EPS = 9, 20, 1e-5
CASES = [(16, 1, "WithBias", False), (32, 2, "BiasFree", True)]


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    assert got is not None, what
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5 * scale, err_msg=what)


def _leaves(ts):
    """Fresh leaves that require grad (None stays None)."""
    return [None if t is None else t.detach().clone().requires_grad_()
            for t in ts]


def _port_grads(out, leaves, g):
    wanted = [t for t in leaves if t is not None]
    got = iter(torch.autograd.grad(out, wanted, torch.from_numpy(g)))
    return [None if t is None else next(got) for t in leaves]


def _jit_vjp(fn, g, *args):
    """``jax.vjp(fn, *args)`` applied to ``g``, compiled as one program:
    op by op, the DRSformer block's and the MEFC steps' backward take tens
    of seconds on the CPU."""
    return jax.jit(lambda gg, *a: jax.vjp(fn, *a)[1](gg))(g, *args)


def _oihw_grad(a):
    """A JAX HWIO kernel's gradient in torch's OIHW layout."""
    return np.asarray(a).transpose(3, 2, 0, 1)


def _front_case(c, heads, ln_type, bias, seed):
    rng = np.random.default_rng(seed)
    jw = _weights(rng, c, heads, ln_type, bias)
    x = rng.standard_normal((2, H, W, c)).astype(np.float32)
    return rng, jw, _port(jw), x


def _check_params(got, want_j, names):
    """Port gradients (torch layout) against JAX's (HWIO kernels for the
    4-D ones, which ``_port`` transposed), None where a bias is absent."""
    for name, gt, wj in zip(names, got, want_j):
        if wj is None:
            assert gt is None, name
            continue
        wj = np.asarray(wj)
        _close(gt, _oihw_grad(wj) if wj.ndim == 4 else wj.reshape(gt.shape),
               name)


@pytest.mark.parametrize("c,heads,ln_type,bias", CASES)
def test_ln_qkv_dwconv_grads_match_jax_vjp(c, heads, ln_type, bias):
    rng, jw, p, x = _front_case(c, heads, ln_type, bias, seed=c + heads)
    g = rng.standard_normal((2, H, W, 3 * c)).astype(np.float32)
    gx, gp = _jit_vjp(lambda xx, pp: JM.fused_ln_qkv_dwconv(xx, pp, ln_type,
                                                            EPS),
                      jnp.asarray(g), jnp.asarray(x), _j(*jw[:6]))

    leaves = _leaves([torch.from_numpy(x), *p.front()])
    out = TM.ln_qkv_dwconv(leaves[0], TB.FrontParams(*leaves[1:]), EPS)
    assert type(out.grad_fn).__name__ == "_LnQkvDwconvBackward"
    got = _port_grads(out, leaves, g)
    _close(got[0], gx, "x")
    _check_params(got[1:], gp, TB.FrontParams._fields)


def _slot_pad(qkv, c, cps=128):
    """The port's [q | k | v] map in the JAX split variant's 128-lane
    slots."""
    parts = np.split(qkv, 3, axis=-1)
    pad = ((0, 0),) * 3 + ((0, cps - c),)
    return np.concatenate([np.pad(t, pad) for t in parts], axis=-1)


@pytest.mark.parametrize("c,heads,ln_type,bias", CASES)
def test_fused_mdta_core_grads_match_jax_vjp(c, heads, ln_type, bias):
    rng, jw, p, x = _front_case(c, heads, ln_type, bias, seed=20 + c + heads)
    qkv = (0.5 * rng.standard_normal((2, H, W, 3 * c))).astype(np.float32)
    g = rng.standard_normal((2, H, W, c)).astype(np.float32)
    temp, wp, bp = jw[6], jw[7], jw[8]
    args = [jnp.asarray(_slot_pad(qkv, c)), jnp.asarray(x), *_j(temp, wp)]
    if bp is None:
        fn = lambda q, xx, t, w: JA.fused_mdta_core(q, xx, t, w, None,  # noqa: E731
                                                    heads)
    else:
        fn = lambda q, xx, t, w, bb: JA.fused_mdta_core(q, xx, t, w, bb,  # noqa: E731
                                                        heads)
        args.append(jnp.asarray(bp))
    want = list(_jit_vjp(fn, jnp.asarray(g), *args))
    want += [None] if bp is None else []
    gq = np.asarray(want[0])
    want[0] = np.concatenate([gq[..., i * 128:i * 128 + c] for i in range(3)],
                             axis=-1)

    leaves = _leaves([torch.from_numpy(qkv), torch.from_numpy(x),
                      p.temperature, p.proj_w, p.proj_b])
    out = TA.fused_mdta_core(*leaves, heads)
    assert type(out.grad_fn).__name__ == "_MdtaCoreBackward"
    got = _port_grads(out, leaves, g)
    _close(got[0], want[0], "qkv")
    _close(got[1], want[1], "x")
    _check_params(got[2:], want[2:], ("temperature", "proj_w", "proj_b"))


@pytest.mark.parametrize("c,heads,ln_type,bias", CASES)
def test_fused_ln_gdfn_grads_match_jax_vjp(c, heads, ln_type, bias):
    rng, jw, p, x = _front_case(c, heads, ln_type, bias, seed=40 + c + heads)
    g = rng.standard_normal((2, H, W, c)).astype(np.float32)
    gx, gp = _jit_vjp(lambda xx, pp: JG.fused_ln_gdfn(xx, pp, ln_type, EPS),
                      jnp.asarray(g), jnp.asarray(x), _j(*jw[9:]))

    leaves = _leaves([torch.from_numpy(x), *p.gdfn()])
    out = TG.fused_ln_gdfn(leaves[0], TB.GDFNParams(*leaves[1:]), EPS)
    assert type(out.grad_fn).__name__ == "_LnGdfnBackward"
    got = _port_grads(out, leaves, g)
    _close(got[0], gx, "x")
    _check_params(got[1:], gp, TB.GDFNParams._fields)


def test_fused_drs_block_grads_match_jax_vjp():
    """C 24 in 2 heads with expansion 2.66: hidden 63, odd, so one
    stage-2 group pairs d3 with d5; BiasFree, so every conv has a bias."""
    c, heads, ln_type = 24, 2, "BiasFree"
    rng = np.random.default_rng(c + heads)
    jp = _drs_jax_params(rng, c, heads, 2.66, ln_type)
    h, w = 12, 10
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    g = rng.standard_normal((1, h, w, c)).astype(np.float32)
    cfg = (c, w, heads, ln_type, EPS)
    gxc, gp = _jit_vjp(lambda xc, pp: JD.fused_drs_block(xc, pp, cfg),
                       JD.canvas_pad(jnp.asarray(g), border=JD.BORDER),
                       JD.canvas_pad(jnp.asarray(x), border=JD.BORDER),
                       _drs_jnp(jp))

    leaves = _leaves([torch.from_numpy(x), *_drs_port_params(jp)])
    out = TD.fused_drs_block(leaves[0], TD.DRSBlockParams(*leaves[1:]),
                             heads, EPS)
    assert type(out.grad_fn).__name__ == "_DRSBlockBackward"
    got = _port_grads(out, leaves, g)
    _close(got[0], JD.canvas_unpad(gxc, w, c, border=JD.BORDER), "x")
    gp = list(gp)
    gp[7] = np.concatenate([np.asarray(t) for t in gp[7]])  # attn1..attn4
    _check_params(got[1:], gp, TD.DRSBlockParams._fields)


def test_fused_mefc_steps_grads_match_jax_vjp():
    """One step at 9x7, where the 7x7 taps reach past the image."""
    rng = np.random.default_rng(7)
    c, h, w, steps = 8, 9, 7, 1
    raw = _jax_steps(rng, c)[:steps]
    x = np.abs(rng.standard_normal((2, h, w, c))).astype(np.float32) * 0.5
    logits = rng.standard_normal((2, steps, TF.NUM_OPS)).astype(np.float32)
    weights = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    g = rng.standard_normal((2, h, w, c)).astype(np.float32)
    gx, graw, gwt = _jit_vjp(JF.fused_mefc_steps, jnp.asarray(g),
                             jnp.asarray(x), jax.tree.map(jnp.asarray, raw),
                             jnp.asarray(weights))

    steps = _port_steps(raw)
    flat = _leaves(TF._flat(steps))
    xt, wt = _leaves([torch.from_numpy(x), torch.from_numpy(weights)])
    out = TF.fused_mefc_steps(xt, TF._unflat(flat), wt)
    assert type(out.grad_fn).__name__ == "_MEFCStepsBackward"
    got = _port_grads(out, [xt, wt, *flat], g)
    _close(got[0], gx, "x")
    _close(got[1], gwt, "weights")
    want = [_oihw_grad(a) for a in TF._flat(_port_steps_jax(graw))]
    assert len(want) == len(flat)
    for i, (gt, wj) in enumerate(zip(got[2:], want)):
        _close(gt, wj, f"step parameter {i}")


def _port_steps_jax(raw):
    """The JAX steps' tree in the port's StepParams order (HWIO kept)."""
    return [TF.StepParams([s["dwa"] for s in sp["sep"]],
                          [s["w1"] for s in sp["sep"]],
                          [s["dwb"] for s in sp["sep"]],
                          [s["w2"] for s in sp["sep"]],
                          [d["dw"] for d in sp["dil"]],
                          [d["w1"] for d in sp["dil"]], sp["wcat"])
            for sp in raw]


# (B, H, W, C, wc, ks): C > wc everywhere, so the tile map is exercised
SKA_CASES = [(2, 7, 9, 12, 2, 3), (1, 7, 9, 24, 6, 3), (1, 7, 9, 12, 6, 5),
             (2, 5, 6, 32, 16, 3)]


def _ska_inputs(case, seed):
    b, h, w, c, wc, ks = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c), dtype=np.float32),
            rng.standard_normal((b, h, w, wc, ks * ks), dtype=np.float32),
            rng.standard_normal((b, h, w, c), dtype=np.float32))


@pytest.mark.parametrize("case", SKA_CASES)
def test_ska_bwd_plain_equals_jax_ska_bwd(case):
    x, w, go = _ska_inputs(case, seed=1)
    gx, gw = JS._ska_bwd((jnp.asarray(x), jnp.asarray(w)), jnp.asarray(go))
    tx, tw = ska_bwd_plain(*map(torch.from_numpy, (x, w, go)))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(gx))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(gw))


@pytest.mark.parametrize("case", SKA_CASES[:2])
def test_ska_grads_match_jax_vjp(case, monkeypatch):
    """Through the port's ``_SKA`` and the JAX custom VJP, whose forward
    runs the Pallas kernel in interpret mode."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    x, w, go = _ska_inputs(case, seed=2)
    out, vjp = jax.vjp(JS.ska_pallas, jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(go))
    leaves = _leaves([torch.from_numpy(x), torch.from_numpy(w)])
    got_out = TS.ska(*leaves)
    assert type(got_out.grad_fn).__name__ == "_SKABackward"
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    got = _port_grads(got_out, leaves, go)
    _close(got[0], gx, "x")
    _close(got[1], gw, "w")


def test_backward_recomputes_without_the_forward_passes(monkeypatch):
    """The backward runs the reference composition only: each forward pass
    (here its plain version, counted by call) runs once, in the forward;
    with nothing to differentiate there is no node."""
    _, jw, p, x = _front_case(16, 1, "WithBias", False, seed=3)
    calls = []

    def counting(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped

    for mod, name in ((TM, "ln_qkv_dwconv_ref"), (TG, "ln_gdfn_ref"),
                      (TA, "attn_acc_ref"), (TA, "attn_apply_ref")):
        monkeypatch.setattr(mod, name, counting(getattr(mod, name)))
    xt = torch.from_numpy(x).requires_grad_()
    qkv = TM.ln_qkv_dwconv(xt, p.front(), EPS)
    y = TA.fused_mdta_core(qkv, xt, p.temperature, p.proj_w, p.proj_b, 1)
    TG.fused_ln_gdfn(y, p.gdfn(), EPS).sum().backward()
    assert sorted(calls) == sorted(["ln_qkv_dwconv_ref", "attn_acc_ref",
                                    "attn_apply_ref", "ln_gdfn_ref"])
    assert xt.grad is not None and torch.isfinite(xt.grad).all()
    plain = torch.from_numpy(x)
    for out in (TM.ln_qkv_dwconv(plain, p.front(), EPS),
                TG.fused_ln_gdfn(plain, p.gdfn(), EPS)):
        assert out.grad_fn is None
    with torch.no_grad():
        assert TG.fused_ln_gdfn(xt, p.gdfn(), EPS).grad_fn is None
