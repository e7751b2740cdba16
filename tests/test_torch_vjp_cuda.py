"""The kernel APIs' backwards on the card: the recompute VJPs, SKA's two
backward kernels, and the configurations ``build_model`` moves off the
kernels.

Every test here is marked ``cuda`` and skips without a CUDA device. This
file imports no jax (tests/test_torch_vjp.py holds the same VJPs to the JAX
custom VJPs on the CPU):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vjp_cuda.py -q

* ``ln_qkv_dwconv`` (K4), ``fused_mdta_core`` (K5, K6), ``fused_ln_gdfn``
  (K3), ``fused_drs_block`` (K1, K7) and ``fused_mefc_steps`` (K8), in
  bf16: the forward launches each kernel once, the backward none, and the
  gradients of the input and of the parameters are those of the plain
  recompute (the reference composition the JAX ``_bwd`` differentiates)
  within 4e-3 of the largest |gradient|, with cuDNN held to its
  deterministic algorithms. With nothing to differentiate the call is the
  launch itself.
* ``ska_bwd_x`` and ``ska_bwd_w`` (``csrc/ska_bwd.cu``) against
  ``ska_bwd_plain`` at LSNet-B's three SKA shapes and LSNet-T's two (batch
  4) and a 13x10 map at C 64 / wc 16, which take the strip kernels, and a
  ragged 7x9 at C 24 / wc 6 and C 12 / wc 2, and k = 5, which take the
  simple ones (``bwd_route`` says which), in bf16 and fp32: the same fp32
  products summed in the same order, each rounded on its own, so the bits
  are the plain version's; K9's rule against the fp32 oracle too; two runs
  equal; the images of a batch independent. An unaligned view of go takes
  the simple kernels, with the same bits. Through ``ska``'s ``_SKA``: one
  launch of each backward kernel, no forward launch.
* ``build_model``: a ``--fp32`` Restormer restores through
  ``make_restore_fn`` on the card with no kernel launch (the kernels take
  bf16); a Restormer at ``model_kwargs.dim=24`` (head width 24) takes a
  train step in bf16 with every block on K1 and K2, padded to heads of 32
  (``kernels/widths.py``), one launch each a block.
"""

import numpy as np
import pytest
import torch
from test_torch_block_cuda import _inputs, _rel
from test_torch_drs_cuda import drs_params, step_params

from image_restoration_tpu_torch.kernels import attn_core as KA
from image_restoration_tpu_torch.kernels import block as KB
from image_restoration_tpu_torch.kernels import drs_block as KD
from image_restoration_tpu_torch.kernels import gdfn as KG
from image_restoration_tpu_torch.kernels import mdta as KM
from image_restoration_tpu_torch.kernels import mefc as KF
from image_restoration_tpu_torch.kernels import ska as KS
from image_restoration_tpu_torch.ops.ska import ska_bwd_plain

KERNELS = (KB.block_front, KB.block_apply_gdfn, KM.ln_qkv_dwconv,
           KA.attn_acc, KA.attn_apply, KG.fused_ln_gdfn, KD.drs_apply_msfn,
           KF.mefc_step, KS.ska, KS.ska_bwd_x, KS.ska_bwd_w)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


def _counts():
    return [k.launches for k in KERNELS]


def _leaves(ts):
    return [None if t is None else t.detach().clone().requires_grad_()
            for t in ts]


def _check_vjp(api, reference, inputs, launched):
    """``api(*leaves)``'s forward launches ``launched`` (kernel: count),
    its backward nothing; its gradients are ``reference``'s."""
    leaves = _leaves(inputs)
    before = _counts()
    torch.backends.cudnn.deterministic = True  # reset by the fixture
    out = api(*leaves)
    after = _counts()
    assert {k.__name__: a - b for k, a, b in zip(KERNELS, after, before)
            if a != b} == launched
    gen = torch.Generator(device=out.device).manual_seed(0)
    g = torch.randn(out.shape, generator=gen, device=out.device)
    got = torch.autograd.grad((out.float() * g).sum(),
                              [t for t in leaves if t is not None])
    torch.cuda.synchronize()
    assert _counts() == after
    ref_leaves = _leaves(inputs)
    want = torch.autograd.grad((reference(*ref_leaves).float() * g).sum(),
                               [t for t in ref_leaves if t is not None])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        assert _rel(a, b) < 4e-3
    with torch.no_grad():
        assert api(*leaves).grad_fn is None


def _bf16(rng, device, *shape, scale=1.0):
    a = scale * rng.standard_normal(shape)
    return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads", [(24, 20, 48, 1), (16, 16, 384, 8),
                                         (13, 21, 96, 2)])
def test_three_kernel_vjps(cuda, h, w, c, heads):
    p, x = _inputs(cuda, h, w, c, heads, "BiasFree", seed=c + heads, batch=2)
    _check_vjp(lambda x, *q: KM.ln_qkv_dwconv(x, KB.FrontParams(*q)),
               lambda x, *q: KB.reference_front(x, KB.FrontParams(*q)),
               (x, *p.front()), {"ln_qkv_dwconv": 1})
    qkv = KM.ln_qkv_dwconv(x, p.front())
    _check_vjp(lambda *t: KA.fused_mdta_core(*t, heads),
               lambda *t: KB.reference_core(*t, heads),
               (qkv, x, p.temperature, p.proj_w, p.proj_b),
               {"attn_acc": 1, "attn_apply": 1})
    _check_vjp(lambda x, *q: KG.fused_ln_gdfn(x, KB.GDFNParams(*q)),
               lambda x, *q: KB.reference_ln_gdfn(x, KB.GDFNParams(*q)),
               (x, *p.gdfn()), {"fused_ln_gdfn": 1})


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads", [(19, 37, 48, 1), (16, 16, 384, 8)])
def test_drs_block_vjp(cuda, h, w, c, heads):
    rng = np.random.default_rng(c)
    p = drs_params(rng, c, heads, 2.66, "WithBias", cuda)
    x = _bf16(rng, cuda, 2, h, w, c)
    _check_vjp(lambda x, *q: KD.fused_drs_block(x, KD.DRSBlockParams(*q),
                                                heads),
               lambda x, *q: KD.reference_drs_block(
                   x, KD.DRSBlockParams(*q), heads),
               (x, *p), {"block_front": 1, "drs_apply_msfn": 1})


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", [(19, 37, 48), (32, 32, 96)])
def test_mefc_steps_vjp(cuda, h, w, c):
    rng = np.random.default_rng(c)
    steps = [step_params(rng, c, cuda) for _ in range(4)]
    x = _bf16(rng, cuda, 2, h, w, c).abs()
    logits = torch.from_numpy(rng.standard_normal((2, 4, KF.NUM_OPS))
                              .astype(np.float32))
    weights = torch.softmax(logits, -1).to(cuda, torch.bfloat16)
    _check_vjp(lambda x, wt, *f: KF.fused_mefc_steps(x, KF._unflat(f), wt),
               lambda x, wt, *f: KF.reference_steps(x, KF._unflat(f), wt),
               (x, weights, *KF._flat(steps)), {"mefc_step": 4})


# (B, H, W, C, wc, ks): LSNet-B's three shapes, the simple path's small
# widths and k = 5, LSNet-T's two shapes, a map whose H no strip table
# divides
SKA_CASES = [(4, 28, 28, 128, 16, 3), (4, 14, 14, 256, 32, 3),
             (4, 7, 7, 384, 48, 3), (2, 7, 9, 24, 6, 3), (2, 7, 9, 12, 2, 3),
             (1, 7, 9, 24, 6, 5), (4, 14, 14, 128, 16, 3),
             (4, 7, 7, 192, 24, 3), (2, 13, 10, 64, 16, 3)]


def _bwd_path(case):
    """The path of csrc/ska_bwd.cu a case takes: the strip kernels at k = 3
    with wc a multiple of 8."""
    return "strip" if case[5] == 3 and case[4] % 8 == 0 else "simple"


def _ska_inputs(case, device, seed, dtype):
    b, h, w, c, wc, ks = case
    rng = np.random.default_rng(seed)

    def t(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).to(device, dtype)

    return t(b, h, w, c), t(b, h, w, wc, ks * ks), t(b, h, w, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SKA_CASES)
def test_ska_backward_kernels(cuda, case, dtype):
    x, w, go = _ska_inputs(case, cuda, seed=sum(case), dtype=dtype)
    assert KS.bwd_route(x, w, go, "x") == KS.bwd_route(x, w, go, "w") == \
        _bwd_path(case)
    before = (KS.ska_bwd_x.launches, KS.ska_bwd_w.launches)
    gx, gw = KS.ska_bwd_x(x, w, go), KS.ska_bwd_w(x, w, go)
    again = KS.ska_bwd_x(x, w, go), KS.ska_bwd_w(x, w, go)
    torch.cuda.synchronize()
    assert (KS.ska_bwd_x.launches - before[0],
            KS.ska_bwd_w.launches - before[1]) == (2, 2)
    px, pw = ska_bwd_plain(x, w, go)
    ox, ow = ska_bwd_plain(x.float(), w.float(), go.float())
    for got, plain, oracle, rerun in ((gx, px, ox, again[0]),
                                      (gw, pw, ow, again[1])):
        assert got.dtype == dtype and got.shape == plain.shape
        assert torch.isfinite(got).all()
        assert torch.equal(got, plain) and torch.equal(got, rerun)
        if dtype == torch.float32:
            assert _rel(got, oracle) <= 1e-5
        else:
            assert _rel(got, oracle) < max(3 * _rel(plain, oracle), 4e-3)
    if case[0] > 1:  # each image's gradients are those of it alone
        one = KS.ska_bwd_x(x[1:2], w[1:2], go[1:2]), \
            KS.ska_bwd_w(x[1:2], w[1:2], go[1:2])
        assert torch.equal(one[0], gx[1:2]) and torch.equal(one[1], gw[1:2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ska_backward_unaligned_view_takes_the_simple_kernels(cuda, dtype):
    """go 2 or 4 bytes past an aligned allocation: both gradients take the
    simple kernels, which give the strip kernels' bits."""
    x, w, go = _ska_inputs(SKA_CASES[0], cuda, seed=4, dtype=dtype)
    base = torch.empty(go.numel() + 1, dtype=dtype, device=cuda)
    gv = base[1:].view(go.shape)
    gv.copy_(go)
    assert gv.is_contiguous() and gv.data_ptr() % 16
    assert KS.bwd_route(x, w, go, "x") == "strip"
    assert KS.bwd_route(x, w, gv, "x") == KS.bwd_route(x, w, gv, "w") == \
        "simple"
    for k, fn in enumerate((KS.ska_bwd_x, KS.ska_bwd_w)):
        got, want = fn(x, w, gv), fn(x, w, go)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(got, ska_bwd_plain(x, w, go)[k])


@pytest.mark.cuda
def test_ska_differentiates_through_its_backward_kernels(cuda):
    x, w, go = _ska_inputs(SKA_CASES[0], cuda, seed=3, dtype=torch.bfloat16)
    xg, wg = x.requires_grad_(), w.requires_grad_()
    before = _counts()
    out = KS.ska(xg, wg)
    mid = _counts()
    gx, gw = torch.autograd.grad(out, (xg, wg), go)
    torch.cuda.synchronize()
    names = [k.__name__ for k in KERNELS]
    assert [m - b for m, b in zip(mid, before)] == [
        n == "ska" for n in names]
    assert [a - m for a, m in zip(_counts(), mid)] == [
        n in ("ska_bwd_x", "ska_bwd_w") for n in names]
    px, pw = ska_bwd_plain(x, w, go)
    assert torch.equal(gx, px) and torch.equal(gw, pw)
    assert torch.equal(out, KS.ska(x.detach(), w.detach()))
    (gw_only,) = torch.autograd.grad(KS.ska(x.detach(), wg), wg, go)
    assert torch.equal(gw_only, pw)


SMALL = ["--set", "model_kwargs.num_blocks=(1,1,1,1)",
         "--set", "model_kwargs.num_refinement_blocks=1"]


@pytest.mark.cuda
def test_fp32_restore_runs_plain_on_the_card(cuda, capsys):
    from image_restoration_tpu_torch.cli.infer import make_restore_fn
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.utils.options import parse_options

    cfg = parse_options(["--fp32", *SMALL])
    model = build_model(cfg)
    assert "fused_block off" in capsys.readouterr().out
    before = _counts()
    img = np.random.default_rng(0).random((37, 45, 3), dtype=np.float32)
    out = make_restore_fn(cfg, model)(img)
    assert out.shape == img.shape and np.isfinite(out).all()
    assert _counts() == before


@pytest.mark.cuda
def test_width_24_train_step_on_the_card(cuda, capsys):
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.train import trainer as T
    from image_restoration_tpu_torch.utils.options import parse_options

    cfg = parse_options(["--set", "model_kwargs.dim=24", *SMALL])
    model = build_model(cfg).train()
    assert capsys.readouterr().out == ""  # no flag off: the pair runs padded
    blocks = sum(getattr(m, "fused_block", None) is True
                 for m in model.modules())
    tcfg = T.TrainerConfig(learning_rate=1e-3)
    tx = T.make_optimizer(tcfg)
    state = T.TrainState.create(model, tx)
    rng = np.random.default_rng(1)
    gt = torch.from_numpy(rng.random((2, 3, 64, 64), dtype=np.float32))
    batch = {"lq": (gt + 0.05).to(cuda), "gt": gt.to(cuda)}
    before = (KB.block_front.launches, KB.block_apply_gdfn.launches)
    state, logs = T.make_train_step(model, tx, tcfg)(state, batch)
    torch.cuda.synchronize()
    assert state.step == 1 and torch.isfinite(logs["total"]).item()
    # one K1 and one K2 a block in the forward; the backward recomputes
    assert blocks == 8 and (KB.block_front.launches,
                            KB.block_apply_gdfn.launches) == (
        before[0] + blocks, before[1] + blocks)
