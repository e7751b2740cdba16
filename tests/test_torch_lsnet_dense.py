"""The port's dense engines over LSNet (``models/lsnet_dense.py``) against
the JAX package's: anchors, the box coder, IoU, the RetinaNet loss and
decoding, the whole RetinaNet and Semantic-FPN, and the segmentation
loss and mIoU.

The JAX models' variables (params and LSNet's BatchNorm ``batch_stats``)
are seeded from numpy (kernels at the fan-in scale, norm weights near 1,
biases and running means near 0, running variances in [0.5, 1.5]) and
reach the port through ``state_dict_from_jax`` with LSNet's key map; both
run in eval mode (the JAX engines' ``train=False``, the only mode JAX can
differentiate without a mutable ``batch_stats``), fp32, JAX jitted at
"highest" matmul precision, torch with TF32 off.

* ``make_anchors`` at RetinaNet's six levels of a 128x128 input: equal to
  JAX's bit for bit (the same fp32 operations). ``box_iou``,
  ``encode_deltas`` and ``decode_deltas`` on seeded boxes (one degenerate):
  rtol 1e-6, atol 1e-6.
* ``retinanet_loss`` with two padded slots after a valid box whose best
  anchor is anchor 0 (XLA's in-order scatter hands anchor 0 to the last
  padded slot, which drops that box's claim) and other valid boxes: both
  terms and their gradients in the logits and deltas at rtol 1e-5, atol
  1e-6 x the largest gradient.
* ``decode_detections`` where two same-class candidates overlap past the
  IoU threshold (the lower-scored one is suppressed) and a score sits
  under the threshold: the same labels and order, scores and boxes at
  rtol 1e-6.
* The whole RetinaNet (LSNet at 16/32/48/64, FPN 32, 5 classes) and
  Semantic-FPN (seg_dim 32, 7 classes; GroupNorm(32)) at 128x128: fp32
  outputs within atol 1e-5 x max|output|, rtol 1e-4; the level sizes
  equal. The port's keys give the JAX tree back through JAX's
  ``import_variables`` with its LSNet key map.
* ``segmentation_ce_loss`` with ignored pixels (rtol 1e-6) and
  ``mean_iou`` with a class absent from both maps (NaN in both, the mean
  over the rest): equal to JAX's at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import ATOL, RTOL, traceable_retinanet
from moe_parity import compiled

from image_restoration_tpu.models import lsnet as JL
from image_restoration_tpu.models import lsnet_dense as J
from image_restoration_tpu.utils.torch_import import import_variables
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import lsnet_dense as T
from image_restoration_tpu_torch.models.lsnet import lsnet_key_map
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

BACKBONE = dict(embed_dim=(16, 32, 48, 64), depth=(1, 2, 2, 2), img_size=128)
SIZES = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
STRIDES = (8, 16, 32, 64, 128, 256)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"), traceable_retinanet():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, n, span=128.0):
    xy = rng.random((n, 2)) * span
    wh = rng.random((n, 2)) * span / 2 + 1
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_anchors_and_coder():
    want = np.asarray(J.make_anchors(SIZES, STRIDES))
    got = T.make_anchors(SIZES, STRIDES)
    np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40), _boxes(rng, 7)
    b[3] = [5, 5, 5, 9]  # no area
    kw = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(T.box_iou(_t(a), _t(b)).numpy(),
                               np.asarray(J.box_iou(a, b)), **kw)
    enc = np.asarray(J.encode_deltas(a[:7], b))
    np.testing.assert_allclose(T.encode_deltas(_t(a[:7]), _t(b)).numpy(),
                               enc, **kw)
    d = rng.standard_normal((40, 4)).astype(np.float32) * 3
    d[0, 2:] = [20.0, -20.0]  # clipped at +-16
    np.testing.assert_allclose(T.decode_deltas(_t(a), _t(d)).numpy(),
                               np.asarray(J.decode_deltas(a, d)), **kw)


def _loss_inputs(rng, k=6):
    anchors = np.asarray(J.make_anchors(SIZES, STRIDES))
    n = anchors.shape[0]
    gt = _boxes(rng, 5)
    gt[0] = anchors[0] + np.array([0.5, -0.5, 0.5, 0.5], np.float32)
    gt[1] = anchors[200] + np.array([2.0, 1.0, -1.0, 3.0], np.float32)
    valid = np.array([True, True, True, False, False])
    labels = np.array([2, 4, 1, 0, 3])
    logits = rng.standard_normal((n, k)).astype(np.float32) * 2
    deltas = rng.standard_normal((n, 4)).astype(np.float32) * 0.3
    return logits, deltas, anchors, gt, labels, valid


def test_retinanet_loss_and_gradient_with_padded_slots():
    rng = np.random.default_rng(1)
    logits, deltas, anchors, gt, labels, valid = _loss_inputs(rng)
    # anchor 0 is box 0's best anchor, and every padded slot's
    iou = np.asarray(J.box_iou(anchors, gt)) * valid[None]
    assert iou.argmax(0)[0] == 0 and iou.argmax(0)[3:].tolist() == [0, 0]

    consts = [jnp.asarray(a) for a in (anchors, gt, labels, valid)]

    def jloss(lg, dl):
        c, b = J.retinanet_loss(lg, dl, *consts, 6)
        return c + 2 * b, (c, b)

    (_, (jc, jb)), (jgl, jgd) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(logits, deltas)
    lg, dl = _t(logits).requires_grad_(), _t(deltas).requires_grad_()
    tc, tb = T.retinanet_loss(lg, dl, _t(anchors), _t(gt), _t(labels),
                              _t(valid), 6)
    (tc + 2 * tb).backward()
    np.testing.assert_allclose([tc.item(), tb.item()],
                               [float(jc), float(jb)], rtol=1e-5)
    for got, want in ((lg.grad, jgl), (dl.grad, jgd)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_decode_detections_suppresses_overlaps():
    rng = np.random.default_rng(2)
    anchors = np.asarray(J.make_anchors(SIZES, STRIDES))
    n = anchors.shape[0]
    logits = np.full((n, 6), -9.0, np.float32)
    deltas = np.zeros((n, 4), np.float32)
    # anchors 9 and 10 (one cell, scales 1 and 2^(1/3)) overlap past 0.5
    logits[9, 3], logits[10, 3] = 3.0, 2.0
    logits[10, 1] = 2.5  # another class: kept
    logits[500, 3] = 1.0
    logits[700, 5] = -3.2  # under the score threshold after the sigmoid
    logits[800:900] = rng.standard_normal((100, 6)).astype(np.float32)
    assert np.asarray(J.box_iou(anchors[9:10], anchors[10:11]))[0, 0] > 0.5
    want = jax.jit(J.decode_detections)(logits, deltas, anchors)
    got = T.decode_detections(_t(logits), _t(deltas), _t(anchors))
    wb, ws, wl = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[2].numpy(), wl)
    np.testing.assert_allclose(got[1].numpy(), ws, rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), wb, rtol=1e-6, atol=1e-4)
    kept = {(int(l), round(float(s), 4)) for l, s in zip(wl, ws) if s > 0}
    assert (3, round(1 / (1 + np.exp(-2.0)), 4)) not in kept  # suppressed
    assert (1, round(1 / (1 + np.exp(-2.5)), 4)) in kept


def _seeded_variables(jmod, x, rng):
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            z = rng.standard_normal(v.shape)
            if k == "kernel":
                z = z / np.sqrt(np.prod(v.shape[:-1]))
            elif k in ("weight", "scale"):
                z = 1.0 + 0.2 * z
            elif k == "running_var":
                z = 0.5 + rng.random(v.shape)
            elif k == "attention_biases":
                z = 0.5 * z
            else:  # bias, running_mean
                z = 0.2 * z
            out[k] = z.astype(np.float32)
        return out

    return {c: walk(t) for c, t in shapes.items()}


def _dense_pair(name, jcls, **kw):
    rng = np.random.default_rng(3)
    x = rng.random((2, 128, 128, 3), dtype=np.float32)
    jmod = jcls(**BACKBONE, **kw)
    variables = _seeded_variables(jmod, x, rng)
    tmod = get_model(name, **BACKBONE, **kw).eval()
    tmod.load_state_dict(state_dict_from_jax(
        variables["params"], tmod.state_dict(), lsnet_key_map,
        variables["batch_stats"]), strict=True)
    back = import_variables(variables, {k: v.numpy() for k, v in
                                        tmod.state_dict().items()},
                            key_map=JL.lsnet_key_map)
    jax.tree.map(np.testing.assert_array_equal, back, variables)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    return jmod, variables, tmod, x, xt


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, RTOL,
                               ATOL * np.abs(want).max())


def test_retinanet_matches_jax():
    jmod, variables, tmod, x, xt = _dense_pair(
        "retinanet_lsnet", J.RetinaNetLSNet, num_classes=5, fpn_dim=32)
    jcls, jbox = compiled(lambda v, a: jmod.apply(v, a)[:2], variables, x)
    with torch.no_grad():
        cls, box, tsizes = tmod(xt)
    _close(cls, jcls)
    _close(box, jbox)
    assert [tuple(s) for s in tsizes] == SIZES
    assert tmod.anchors(tsizes).shape[0] == cls.shape[1]


def test_semantic_fpn_matches_jax():
    jmod, variables, tmod, x, xt = _dense_pair(
        "semanticfpn_lsnet", J.SemanticFPNLSNet, num_classes=7, fpn_dim=32,
        seg_dim=32)
    want = compiled(jmod.apply, variables, x)
    with torch.no_grad():
        got = tmod(xt)
    _close(got.permute(0, 2, 3, 1), want)


def test_segmentation_loss_and_mean_iou():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 12, 10, 7)).astype(np.float32)
    labels = rng.integers(0, 6, (2, 12, 10))  # class 6 nowhere
    labels[0, :3] = 255
    pred = logits.argmax(-1)
    pred[pred == 6] = 0
    want = float(J.segmentation_ce_loss(jnp.asarray(logits),
                                        jnp.asarray(labels)))
    got = T.segmentation_ce_loss(_t(logits).permute(0, 3, 1, 2), _t(labels))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    wm, wi = J.mean_iou(jnp.asarray(pred), jnp.asarray(labels), 7)
    gm, gi = T.mean_iou(_t(pred), _t(labels), 7)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=1e-6)
    assert np.isnan(gi[6].item())
    np.testing.assert_allclose(gm.item(), float(wm), rtol=1e-6)
