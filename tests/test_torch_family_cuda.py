"""The block kernel pair (K1 ``block_front``, K2 ``block_apply_gdfn``) at
the shapes CG-IR, MEASNet and NeRD-Rain give it, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. This file imports no jax, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_family_cuda.py -q

Rule (tests/test_tpu_kernels.py's, phase 2 of ``chip_smoke.py``): with the
fp32 plain version as the oracle, the kernel's max error relative to the
oracle's max magnitude is below max(3 x the plain bf16 version's, 4e-3).

- K1 and K2 at MEASNet's (``MODEL_DEFAULTS["measnet"]``, dim 32) block
  shapes serving a 512x512 image: 512^2 x 32 (1 head), 256^2 x 64 (2),
  128^2 x 128 (4), 64^2 x 256 (8) and 512^2 x 64 (1 head, decoder level
  1 and refinement), each at the wrappers' launch tables; two runs give
  the same bits.
- CG-IR's gated block: ``fused_block(..., gate=)`` (K1, the finalize with
  a per-sample (2, heads) temperature and the (2, C) gate folded into A^T
  W_proj, K2) on a batch of two whose images, temperatures and gates
  differ, against ``reference_block(..., gate=)`` (the oracle in fp32,
  the plain version in bf16); two runs give the same bits.
- MoCE-IR's EncoderBlock parameters (``MODEL_DEFAULTS["moce_ir"]``): a
  WithBias LN, a bias on every conv and a GDFN hidden width of 2C, at its
  block shapes serving a 512x512 image: 512^2 x 48 (1 head), 256^2 x 96
  (2), 128^2 x 192 (4) and 64^2 x 384 (8). K1 and K2 each, two runs
  bit-equal; then the whole block (``fused_block``) on a batch of two whose
  images differ at 64^2 x 384 and 128^2 x 192, against
  ``reference_block``.
- SRConvNet, TransWeather and DarkIR (kernel-free: plain torch), each at
  its ``MODEL_DEFAULTS`` widths with seeded weights (the zero-initialised
  DarkIR ``beta``/``gamma`` and the 1e-6 SRConvNet ``layer_scale``
  perturbed) at a small input: the card's fp32 forward against the CPU's
  fp32 forward within 1e-4 relative L2 (TF32 off), and the card's bf16
  forward within 3x the CPU bf16 forward's relative L2 error against it
  (oneDNN off on the CPU: its bf16 convolution is wrong at some shapes).
- HOGformer, SFHformer and MWFormer (kernel-free) the same way at their
  ``MODEL_DEFAULTS`` widths (HOGformer's ``sigma`` and SFHformer's
  ``beta``/``gamma`` perturbed, MWFormer's style vector scaled to O(1) as
  a trained filter's is): the card's fp32 forward within 1e-5 relative L2
  of the CPU's, HOGformer's under the CPU's sort and bin decisions (keys
  within fp32 rounding of a tie decide differently on the two), and the
  card's bf16 forward against the card's fp32 forward within 3x the CPU
  bf16 forward's error against the CPU fp32 one. The ``hogformer`` and
  ``mwformer_style`` recipes give finite losses and gradients in bf16.
- ViG-T and HierViG-T (``MODEL_DEFAULTS``: the JAX field defaults) at
  224x224, batch 2, seeded weights: the card's fp32 logits within 1e-5
  relative L2 of the CPU's (TF32 off), the card's bf16 logits against the
  card's fp32 within 3x the CPU bf16 logits' error against the CPU fp32.
  The GLA at gate logits of -40 on the card (JAX's ``chunk_gla`` gives NaN
  there): finite, with finite gradients, equal to the CPU recurrence
  (atol 1e-5 x max).
- RetinaNet and Semantic-FPN over LSNet-T (``MODEL_DEFAULTS``: 80 and 150
  classes, FPN 256), their BatchNorm statistics set from one train-mode
  forward of two 512x512 images (at 128x128 the last stages' 2x2 and 1x1
  maps give BatchNorm statistics of 8 and 2 values, and the calibrated
  model amplifies rounding past 1e-5): the card's fp32 outputs on a
  256x256 image within 1e-5 relative L2 of the CPU's; in bf16 on the
  card, at 128x128, ``retinanet_loss`` on seeded boxes with padded slots,
  ``segmentation_ce_loss`` with ignored pixels and ``mean_iou`` are
  finite, and so are the losses' gradients.
- IPT (n_feats 24: embed 216, 12 + 12 layers) at tasks 5 and 0 on two
  48x48 windows, and EDT (embed 60, 36 blocks) at ``denoise_30`` on 96x96
  and ``sr_2`` on 48x48, kernel-free, with seeded adapter tails and
  calibrated BatchNorm statistics (``tests/seeding.py`` ``seed_adaptir``):
  the card's fp32 forward within 1e-5 relative L2 of the CPU's (TF32
  off), the card's bf16 forward against the card's fp32 within 3x the
  CPU bf16 forward's error against the CPU fp32 one. In bf16 on the card,
  ``model(x, train=True)`` under an L1 loss gives finite gradients, and
  every adapter's ``tail`` and phase scale gets a nonzero one.
- RectiFormer, FPN-Restormer and MyModel (kernel-free: plain torch) at
  their ``MODEL_DEFAULTS`` (the JAX field defaults) on a 64x64 image,
  MyModel's layer scales and adapter tails seeded and the BatchNorm
  statistics calibrated (``tests/seeding.py`` ``seed_branches``): the
  card's fp32 forward within 1e-5 relative L2 of the CPU's (TF32 off), the
  card's bf16 forward against the card's fp32 within 3x the CPU bf16
  forward's error against the CPU fp32 one. In bf16 on the card an L1
  loss of ``model(x)`` (FPN-Restormer and MyModel with ``train=True``,
  MyModel's routing noise from a device generator) gives finite
  gradients, every parameter one.
- PINN (kernel-free) at its ``MODEL_DEFAULTS`` on a 64x64 image: the
  same two rules. SFSNiD's fp32 runs part at the angle's branch cut (its
  spectrum blocks add a conv branch to ``angle(rfft2)``, which jumps by
  2 pi across the negative real axis, where rounding puts a coefficient
  on either side: ``tools/sfsnid_branch_cut.py``), so its card forward is
  held to the CPU's after its first two encoder stages, where no
  coefficient has crossed, and one of its blocks on a 17x13 map. Both, in
  bf16 on the card, give finite outputs and finite gradients, every
  parameter one (SFSNiD's three deep-supervision outputs).
"""

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.kernels import block as K
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import hogformer as H
from image_restoration_tpu_torch.models import lsnet_dense as D
from image_restoration_tpu_torch.ops import gla
from image_restoration_tpu_torch.train.recipes import make_recipe
from image_restoration_tpu_torch.utils.options import MODEL_DEFAULTS
from seeding import seed_adaptir, seed_branches

# (H, W, C, heads) of MEASNet's K1/K2 calls at a 512x512 input
MEASNET_SHAPES = [(512, 512, 32, 1), (256, 256, 64, 2), (128, 128, 128, 4),
                  (64, 64, 256, 8), (512, 512, 64, 1)]
# (batch, H, W, C, heads) of the gated block
GATED_SHAPES = [(2, 40, 36, 48, 1), (2, 24, 20, 192, 4), (2, 16, 16, 384, 8)]
# (H, W, C, heads) of MoCE-IR's K1/K2 calls at a 512x512 input
MOCE_SHAPES = [(512, 512, 48, 1), (256, 256, 96, 2), (128, 128, 192, 4),
               (64, 64, 384, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(rng, c, heads, device, expansion=2.66, bias=False):
    """Seeded WithBias BlockParams, torch layout: without conv biases at
    GDFN expansion 2.66 (the families' defaults), or MoCE-IR's encoder
    block (``expansion=2.0, bias=True``)."""
    hidden = int(c * expansion)

    def mk(*shape, sc=0.05, base=0.0):
        a = base + sc * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(device)

    def b(n):
        return mk(n, sc=0.1) if bias else None

    return K.BlockParams(
        mk(c, sc=0.1, base=1.0), mk(c, sc=0.1),
        mk(3 * c, c, 1, 1, sc=c ** -0.5), b(3 * c),
        mk(3 * c, 1, 3, 3, sc=0.3), b(3 * c),
        mk(heads, 1, 1, sc=0.3, base=1.0),
        mk(c, c, 1, 1, sc=c ** -0.5), b(c),
        mk(c, sc=0.1, base=1.0), mk(c, sc=0.1),
        mk(2 * hidden, c, 1, 1, sc=c ** -0.5), b(2 * hidden),
        mk(2 * hidden, 1, 3, 3, sc=0.3), b(2 * hidden),
        mk(c, hidden, 1, 1, sc=hidden ** -0.5), b(c))


def _rel(got, oracle):
    scale = oracle.float().abs().max().item() + 1e-12
    return (got.float() - oracle.float()).abs().max().item() / scale


def _holds(got, plain, oracle):
    return _rel(got, oracle) < max(3 * _rel(plain, oracle), 4e-3)


def _case(cuda, h, w, c, heads, seed, batch=1, **block):
    rng = np.random.default_rng(seed)
    p = _params(rng, c, heads, cuda, **block)
    x = torch.from_numpy(rng.standard_normal((batch, h, w, c))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    return rng, p, x


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads", MEASNET_SHAPES)
def test_block_front_at_measnet_widths(cuda, h, w, c, heads):
    _, p, x = _case(cuda, h, w, c, heads, seed=c + heads)
    f = p.front()
    oracle = K.block_front_ref(x.float(), f, heads)
    plain = K.block_front_ref(x, f, heads)
    got = K.block_front(x, f, heads)
    again = K.block_front(x, f, heads)
    torch.cuda.synchronize()
    for name, o, pl, g, a in zip(("v", "gram", "sumsq"), oracle, plain, got,
                                 again):
        assert g.shape == pl.shape and g.dtype == pl.dtype, name
        assert torch.isfinite(g).all(), name
        assert _holds(g, pl, o), name
        assert torch.equal(g, a), name


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads", MEASNET_SHAPES)
def test_block_apply_gdfn_at_measnet_widths(cuda, h, w, c, heads):
    _, p, x = _case(cuda, h, w, c, heads, seed=10 + c + heads)
    v, gram, ss = K.block_front_ref(x, p.front(), heads)
    atw = K.finalize(gram, ss, p.temperature, p.proj_w, torch.bfloat16)
    oracle = K.block_apply_gdfn_ref(v.float(), x.float(), atw.float(), p)
    plain = K.block_apply_gdfn_ref(v, x, atw, p)
    got = K.block_apply_gdfn(v, x, atw, p)
    again = K.block_apply_gdfn(v, x, atw, p)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert _holds(got, plain, oracle)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,heads", GATED_SHAPES)
def test_gated_fused_block_batch2(cuda, b, h, w, c, heads):
    rng, p, x = _case(cuda, h, w, c, heads, seed=20 + c, batch=b)
    temp = torch.from_numpy(np.exp(0.3 * rng.standard_normal((b, heads)))
                            .astype(np.float32)).to(cuda)
    gate = torch.sigmoid(torch.from_numpy(
        rng.standard_normal((b, c)).astype(np.float32))).to(cuda)
    p = p._replace(temperature=temp)
    n1, n2 = K.block_front.launches, K.block_apply_gdfn.launches
    got = K.fused_block(x, p, heads, gate=gate)
    again = K.fused_block(x, p, heads, gate=gate)
    torch.cuda.synchronize()
    assert K.block_front.launches - n1 == 2
    assert K.block_apply_gdfn.launches - n2 == 2
    oracle = K.reference_block(x.float(), p, heads, gate=gate)
    plain = K.reference_block(x, p, heads, gate=gate)
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _holds(got, plain, oracle)
    assert torch.equal(got, again)
    ungated = K.reference_block(x.float(), p, heads)
    assert _rel(ungated, oracle) > 4e-3  # the gate reaches the output


MOCE_BLOCK = dict(expansion=2.0, bias=True)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads", MOCE_SHAPES)
def test_block_pair_at_moce_ir_shapes(cuda, h, w, c, heads):
    """K1, then K2 on K1's plain outputs, with every conv bias and hidden
    2C (padded to a multiple of 32: 96 at C 48, 768 at C 384)."""
    _, p, x = _case(cuda, h, w, c, heads, seed=30 + c, **MOCE_BLOCK)
    assert p.out_w.shape[1] == 2 * c and p.in_b is not None
    f = p.front()
    oracle = K.block_front_ref(x.float(), f, heads)
    plain = K.block_front_ref(x, f, heads)
    got = K.block_front(x, f, heads)
    again = K.block_front(x, f, heads)
    torch.cuda.synchronize()
    for name, o, pl, g, a in zip(("v", "gram", "sumsq"), oracle, plain, got,
                                 again):
        assert torch.isfinite(g).all(), name
        assert _holds(g, pl, o), name
        assert torch.equal(g, a), name
    v, gram, ss = plain
    atw = K.finalize(gram, ss, p.temperature, p.proj_w, torch.bfloat16)
    oracle = K.block_apply_gdfn_ref(v.float(), x.float(), atw.float(), p)
    plain = K.block_apply_gdfn_ref(v, x, atw, p)
    got = K.block_apply_gdfn(v, x, atw, p)
    again = K.block_apply_gdfn(v, x, atw, p)
    torch.cuda.synchronize()
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _holds(got, plain, oracle)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,heads", MOCE_SHAPES[2:])
def test_moce_ir_block_batch2(cuda, h, w, c, heads):
    _, p, x = _case(cuda, h, w, c, heads, seed=40 + c, batch=2,
                    **MOCE_BLOCK)
    got = K.fused_block(x, p, heads)
    torch.cuda.synchronize()
    oracle = K.reference_block(x.float(), p, heads)
    plain = K.reference_block(x, p, heads)
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _holds(got, plain, oracle)
    for i in range(2):  # each image as its own batch of one
        one = K.fused_block(x[i:i + 1].contiguous(), p, heads)
        assert _holds(one[0], plain[i], oracle[i])


# (model, NCHW input) of the kernel-free models' card-against-CPU check
FAMILY_INPUTS = [("srconvnet", (1, 3, 32, 24)),
                 ("transweather", (1, 3, 96, 64)),
                 ("darkir", (1, 3, 60, 44))]


def _rel_l2(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


def _family_model(name, dtype):
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in MODEL_DEFAULTS[name].items()}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        model = get_model(name, **kwargs, dtype=dtype).eval()
        with torch.no_grad():
            for key, p in model.named_parameters():
                if key.endswith(("beta", "gamma", "layer_scale",
                                 "sigma.scale")):
                    p.copy_(0.5 + 0.2 * torch.randn(p.shape))
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", FAMILY_INPUTS)
def test_family_forward_card_against_cpu(cuda, name, shape):
    x = torch.rand(shape, generator=torch.Generator().manual_seed(6))
    with torch.inference_mode(), torch.backends.mkldnn.flags(enabled=False):
        want = _family_model(name, None)(x)
        cpu16 = _family_model(name, torch.bfloat16)(x)
    with torch.inference_mode():
        got32 = _family_model(name, None).to(cuda)(x.to(cuda))
        got16 = _family_model(name, torch.bfloat16).to(cuda)(x.to(cuda))
    assert torch.isfinite(got32).all() and torch.isfinite(got16).all()
    e32, e16, ecpu = (_rel_l2(got32, want), _rel_l2(got16, want),
                      _rel_l2(cpu16, want))
    assert e32 <= 1e-4, e32
    assert e16 <= 3 * ecpu, (e16, ecpu)


# (model, NCHW input) of HOGformer's, SFHformer's and MWFormer's checks
NEW_FAMILY_INPUTS = [("hogformer", (1, 3, 48, 32)),
                     ("sfhformer", (1, 3, 48, 32)),
                     ("mwformer", (1, 3, 96, 64))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", NEW_FAMILY_INPUTS)
def test_new_family_forward_card_against_cpu(cuda, name, shape):
    x = torch.rand(shape, generator=torch.Generator().manual_seed(6))
    models = {dt: _family_model(name, dt) for dt in (None, torch.bfloat16)}
    if name == "mwformer":
        with torch.no_grad():
            scale = models[None].style_filter(x).abs().max()
            for m in models.values():
                m.style_filter.out1_fc.weight.div_(scale)
                m.style_filter.out1_fc.bias.div_(scale)
    with torch.inference_mode(), torch.backends.mkldnn.flags(enabled=False):
        with H.decision_tape([]) as tape:
            want = models[None](x)
        cpu16 = models[torch.bfloat16](x)
    card32, card16 = (models[dt].to(cuda) for dt in (None, torch.bfloat16))
    with torch.inference_mode():
        with H.decision_tape(tape, replay=True):
            got32 = card32(x.to(cuda))
        free32 = card32(x.to(cuda))
        got16 = card16(x.to(cuda))
    assert not tape
    assert all(torch.isfinite(t).all() for t in (got32, free32, got16))
    e32, e16, ecpu = (_rel_l2(got32, want), _rel_l2(got16, free32),
                      _rel_l2(cpu16, want))
    assert e32 <= 1e-5, e32
    assert e16 <= 3 * ecpu, (e16, ecpu)


@pytest.mark.cuda
def test_new_recipes_finite_on_the_card(cuda):
    g = torch.Generator().manual_seed(7)
    gt = torch.rand(2, 3, 64, 64, generator=g)
    lq = (gt + 0.1 * torch.randn(gt.shape, generator=g)).clamp(0, 1)
    hog = _family_model("hogformer", torch.bfloat16).to(cuda).train()
    total, logs = make_recipe("hogformer")(hog(lq.to(cuda)), {},
                                           {"gt": gt.to(cuda)})
    total.backward()
    assert set(logs) == {"l_pix", "l_pear", "l_hog"}
    style = get_model("mwformer_style", dtype=torch.bfloat16).to(cuda)
    emb = style.train()(torch.rand(4, 3, 64, 64, generator=g).to(cuda))
    loss, slogs = make_recipe("mwformer_style")(
        emb, {}, {"de_id": torch.tensor([0, 1, 0, 1], device=cuda)})
    loss.backward()
    for v in (*logs.values(), *slogs.values()):
        assert torch.isfinite(v)
    for m in (hog, style):
        assert all(torch.isfinite(p.grad).all() for p in m.parameters()
                   if p.grad is not None)


def _classifier(name, dtype, seed=8):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return get_model(name, **MODEL_DEFAULTS[name], dtype=dtype).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vig", "vig_h"])
def test_gla_classifiers_card_against_cpu(cuda, name):
    x = torch.rand((2, 3, 224, 224),
                   generator=torch.Generator().manual_seed(9))
    with torch.inference_mode():
        want = _classifier(name, None)(x)
        cpu16 = _classifier(name, torch.bfloat16)(x)
        got32 = _classifier(name, None).to(cuda)(x.to(cuda))
        got16 = _classifier(name, torch.bfloat16).to(cuda)(x.to(cuda))
    assert got16.dtype == torch.bfloat16
    assert torch.isfinite(got32).all() and torch.isfinite(got16).all()
    e32, e16, ecpu = (_rel_l2(got32, want), _rel_l2(got16, got32),
                      _rel_l2(cpu16, want))
    assert e32 <= 1e-5, e32
    assert e16 <= 3 * ecpu, (e16, ecpu)


@pytest.mark.cuda
def test_gla_gate_minus_40_on_the_card(cuda):
    g = torch.Generator().manual_seed(10)
    q, k = (torch.randn(2, 2, 130, 16, generator=g) for _ in range(2))
    v = torch.randn(2, 2, 130, 24, generator=g)
    gk = torch.full((2, 2, 130, 16), -40.0).sigmoid().log() / 16
    ts = [t.to(cuda).requires_grad_() for t in (q, k, v, gk)]
    out = gla.chunk_gla(*ts)
    out.square().sum().backward()
    want = gla.recurrent_gla(q, k, v, gk)
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(t.grad).all() for t in ts)
    err = (out.detach().cpu() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


def _dense(name, dtype, x, seed=11):
    """``name`` at its ``MODEL_DEFAULTS``, seeded, with every BatchNorm's
    statistics those of one train-mode forward of ``x`` (the init's give
    activations that grow through the stages)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = get_model(name, **MODEL_DEFAULTS[name], dtype=dtype)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.momentum = None
    with torch.no_grad():
        model.train()(x)
    return model.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["retinanet_lsnet", "semanticfpn_lsnet"])
def test_dense_card_against_cpu(cuda, name):
    g = torch.Generator().manual_seed(12)
    model = _dense(name, None, torch.rand((2, 3, 512, 512), generator=g))
    x = torch.rand((1, 3, 256, 256), generator=g)
    with torch.inference_mode():
        want = model(x)
        got = model.to(cuda)(x.to(cuda))
    for w, o in zip(*((want, got) if isinstance(want, tuple)
                      else ((want,), (got,)))):
        if isinstance(w, torch.Tensor):
            assert torch.isfinite(o).all()
            assert _rel_l2(o, w) <= 1e-5, _rel_l2(o, w)


@pytest.mark.cuda
def test_dense_losses_finite_on_the_card(cuda):
    g = torch.Generator().manual_seed(13)
    x = torch.rand((2, 3, 128, 128), generator=g)
    det = _dense("retinanet_lsnet", torch.bfloat16, x).to(cuda)
    cls, box, sizes = det(x.to(cuda))
    anchors = det.anchors(sizes, cuda)
    gt = torch.tensor([[10.0, 12.0, 60.0, 70.0], [64.0, 8.0, 120.0, 50.0],
                       [0.0, 0.0, 0.0, 0.0]], device=cuda)
    labels = torch.tensor([3, 17, 0], device=cuda)
    valid = torch.tensor([True, True, False], device=cuda)
    c, b = D.retinanet_loss(cls[0], box[0], anchors, gt, labels, valid, 80)
    (c + b).backward()
    boxes, scores, lab = D.decode_detections(cls[1].detach(),
                                             box[1].detach(), anchors)
    seg = _dense("semanticfpn_lsnet", torch.bfloat16, x).to(cuda)
    logits = seg(x.to(cuda))
    target = torch.randint(0, 150, (2, 128, 128), generator=g).to(cuda)
    target[:, :8] = 255
    ce = D.segmentation_ce_loss(logits, target)
    ce.backward()
    miou, _ = D.mean_iou(logits.argmax(1), target, 150)
    for t in (c, b, ce, miou, boxes, scores):
        assert torch.isfinite(t).all()
    for m in (det, seg):
        assert all(torch.isfinite(p.grad).all() for p in m.parameters()
                   if p.grad is not None)


# (registry name, model kwargs, NCHW input) of IPT's and EDT's checks
ADAPTIR_INPUTS = [("ipt", dict(n_feats=24), (2, 3, 48, 48)),
                  ("ipt", dict(n_feats=24, task_idx=0), (2, 3, 48, 48)),
                  ("edt", dict(embed_dim=60, de_type="denoise_30"),
                   (1, 3, 96, 96)),
                  ("edt", dict(embed_dim=60), (1, 3, 48, 48))]


def _adaptir_pair(name, kw, shape):
    """(fp32 model, bf16 model with its weights, input) on the CPU: the
    seeded init through ``seed_adaptir``."""
    x = torch.rand(shape, generator=torch.Generator().manual_seed(12))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(10)
        m32 = get_model(name, **kw).eval()
    seed_adaptir(m32, 11, x)
    m16 = get_model(name, **kw, dtype=torch.bfloat16).eval()
    m16.load_state_dict(m32.state_dict())
    return m32, m16, x


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,shape", ADAPTIR_INPUTS,
                         ids=["ipt", "ipt_task0", "edt_denoise", "edt_sr"])
def test_adaptir_card_against_cpu(cuda, name, kw, shape):
    m32, m16, x = _adaptir_pair(name, kw, shape)
    with torch.inference_mode(), torch.backends.mkldnn.flags(enabled=False):
        want, cpu16 = m32(x), m16(x)
    with torch.inference_mode():
        got32 = m32.to(cuda)(x.to(cuda))
        got16 = m16.to(cuda)(x.to(cuda))
    assert got32.shape == want.shape and got16.dtype == torch.float32
    assert torch.isfinite(got32).all() and torch.isfinite(got16).all()
    e32, e16, ecpu = (_rel_l2(got32, want), _rel_l2(got16, got32),
                      _rel_l2(cpu16, want))
    assert e32 <= 1e-5, e32
    assert e16 <= 3 * ecpu, (e16, ecpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,shape", ADAPTIR_INPUTS[::2],
                         ids=["ipt", "edt_denoise"])
def test_adaptir_gradients_finite_on_the_card(cuda, name, kw, shape):
    _, m16, x = _adaptir_pair(name, kw, shape)
    m16 = m16.to(cuda)
    x = x.to(cuda)
    loss = (m16(x, train=True) - x).abs().mean()
    loss.backward()
    assert torch.isfinite(loss)
    for key, p in m16.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), key
        if key.endswith(("adaptir.tail.weight", "adaptir.pha_fuse.weight")):
            assert p.grad.abs().max() > 0, key


BRANCH_MODELS = ["rectiformer", "fpn_restormer", "mymodel"]


def _branch_pair(name):
    """(fp32 model, bf16 model with its weights, 64x64 input) on the CPU:
    the seeded init at ``MODEL_DEFAULTS`` through ``seed_branches``."""
    x = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(
        14))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(13)
        m32 = get_model(name, **MODEL_DEFAULTS[name]).eval()
    seed_branches(m32, 15, torch.cat([x, x.flip(-1)]))
    m16 = get_model(name, **MODEL_DEFAULTS[name],
                    dtype=torch.bfloat16).eval()
    m16.load_state_dict(m32.state_dict())
    return m32, m16, x


@pytest.mark.cuda
@pytest.mark.parametrize("name", BRANCH_MODELS)
def test_branch_models_card_against_cpu(cuda, name):
    m32, m16, x = _branch_pair(name)
    with torch.inference_mode(), torch.backends.mkldnn.flags(enabled=False):
        want, cpu16 = m32(x), m16(x)
    with torch.inference_mode():
        got32 = m32.to(cuda)(x.to(cuda))
        got16 = m16.to(cuda)(x.to(cuda))
    assert got32.shape == want.shape and got16.dtype == torch.float32
    assert torch.isfinite(got32).all() and torch.isfinite(got16).all()
    e32, e16, ecpu = (_rel_l2(got32, want), _rel_l2(got16, got32),
                      _rel_l2(cpu16, want))
    assert e32 <= 1e-5, e32
    assert e16 <= 3 * ecpu, (e16, ecpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", BRANCH_MODELS)
def test_branch_models_gradients_finite_on_the_card(cuda, name):
    _, m16, x = _branch_pair(name)
    m16 = m16.to(cuda)
    x = torch.cat([x, x.flip(-2)]).to(cuda)
    kw = {}
    if name != "rectiformer":
        kw["train"] = True
    if name == "mymodel":
        kw["generator"] = torch.Generator(device=cuda).manual_seed(16)
    out = m16(x, **kw)
    out = out[0] if isinstance(out, tuple) else out
    loss = (out - x).abs().mean()
    loss.backward()
    assert torch.isfinite(loss)
    for key, p in m16.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), key


DEMO_MODELS = ["sfsnid", "pinn"]


def _demo_pair(name):
    """(fp32 model, bf16 model with its weights, 64x64 input) on the CPU:
    the seeded init at ``MODEL_DEFAULTS``."""
    x = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(
        17))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(18)
        m32 = get_model(name, **MODEL_DEFAULTS[name]).eval()
    m16 = get_model(name, **MODEL_DEFAULTS[name],
                    dtype=torch.bfloat16).eval()
    m16.load_state_dict(m32.state_dict())
    return m32, m16, x


@pytest.mark.cuda
def test_pinn_card_against_cpu(cuda):
    """PINN's card fp32 forward within 1e-5 relative L2 of the CPU's, its
    bf16 forward against its fp32 one within 3x the CPU bf16 forward's
    error."""
    m32, m16, x = _demo_pair("pinn")
    with torch.inference_mode(), torch.backends.mkldnn.flags(enabled=False):
        want, cpu16 = m32(x), m16(x)
    with torch.inference_mode():
        got32 = m32.to(cuda)(x.to(cuda))
        got16 = m16.to(cuda)(x.to(cuda))
    assert got32.shape == want.shape and got16.dtype == torch.float32
    e32, e16, ecpu = (_rel_l2(got32, want), _rel_l2(got16, got32),
                      _rel_l2(cpu16, want))
    assert e32 <= 1e-5, e32
    assert e16 <= 3 * ecpu, (e16, ecpu)


@pytest.mark.cuda
def test_sfsnid_encoder_card_against_cpu(cuda):
    """SFSNiD at ``MODEL_DEFAULTS`` (chip_smoke.py phase 3q's seed-0 init
    and 64x64 input): the output of its second encoder stage (the SCM and
    the first two stages' six blocks before it) on the card within 1e-5
    relative L2 of the CPU's, fp32, TF32 off. Later stages part at the
    angle's branch cut (``tools/sfsnid_branch_cut.py``)."""
    import copy

    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.utils.options import parse_options
    from image_restoration_tpu_torch.utils.precision import full_fp32

    cfg = parse_options(["--model", "sfsnid", "--device", "cpu", "--seed",
                         "0"])
    m32 = build_model(dict(cfg, bf16=False), device="cpu").eval()
    x = torch.rand((1, 3, 64, 64),
                   generator=torch.Generator().manual_seed(3520))

    def encoder(model, a):
        got = []
        hook = model.Encoder[1].register_forward_hook(
            lambda m, i, o: got.append(o))
        with torch.inference_mode(), full_fp32():
            model(a)
        hook.remove()
        return got[0]

    want = encoder(m32, x)
    got = encoder(copy.deepcopy(m32).to(cuda), x.to(cuda))
    assert _rel_l2(got, want) <= 1e-5, _rel_l2(got, want)


@pytest.mark.cuda
def test_sfsnid_block_card_against_cpu(cuda):
    """One SFSNiD block (64 channels) on a 17x13 map of positive mean, the
    CPU tests' case: the card's fp32 within 1e-5 relative L2 of the
    CPU's."""
    from image_restoration_tpu_torch.models.demo_models import (
        SFSTransformerBlock,
    )

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(19)
        block = SFSTransformerBlock(64).eval()
    x = 1.0 + torch.randn((2, 64, 17, 13),
                          generator=torch.Generator().manual_seed(20))
    with torch.inference_mode():
        want = block(x)
        got = block.to(cuda)(x.to(cuda))
    assert _rel_l2(got, want) <= 1e-5, _rel_l2(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", DEMO_MODELS)
def test_demo_models_finite_on_the_card(cuda, name):
    """SFSNiD (num_res 3, base 32) and PINN, kernel-free, bf16 on the card:
    finite outputs of the input's shape, and an L1 loss gives finite
    gradients, every parameter one (SFSNiD's three deep-supervision
    outputs with ``train=True``)."""
    _, m16, x = _demo_pair(name)
    m16 = m16.to(cuda)
    xb = torch.cat([x, x.flip(-2)]).to(cuda)
    out = m16(xb, train=True) if name == "sfsnid" else [m16(xb)]
    assert out[-1].shape == xb.shape
    loss = sum((o - torch.nn.functional.interpolate(xb, o.shape[-2:]))
               .abs().mean() for o in out)
    loss.backward()
    assert torch.isfinite(loss)
    for key, p in m16.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), key
