"""Dense prediction over the LSNet backbone: RetinaNet detection and
Semantic-FPN segmentation (image_restoration_tpu/models/lsnet_dense.py,
the equivalent of the reference's mmdetection/mmsegmentation configs
``retinanet_lsnet_*_fpn_1x_coco.py`` and its FPN segmentation heads).

Everything is static-shape, as in JAX: ground-truth boxes are padded to a
fixed slot count with a validity mask, NMS is a greedy pass over a fixed
top-k, and anchors are built per (level, feature size).

* :class:`FPN`: lateral 1x1 convs, a top-down nearest-x2 add, 3x3 smooth
  convs, and stride-2 extra levels on the last output (RetinaNet's P6/P7).
* :class:`RetinaNetHead`: shared 4-conv towers, 9 anchors a cell (3 scales
  x 3 ratios), the class bias starting at the focal prior.
* :class:`RetinaNetLSNet` (``retinanet_lsnet``): backbone, FPN and head;
  :func:`retinanet_loss` (max-IoU assignment, focal loss and smooth L1 on
  the encoded deltas) and :func:`decode_detections` (decode, top-k,
  class-aware greedy NMS).
* :class:`SemanticFPNLSNet` (``semanticfpn_lsnet``): every FPN level
  conv + GroupNorm + ReLU and upsampled to stride 8, summed, classified
  and resized to the input; :func:`segmentation_ce_loss`, :func:`mean_iou`.

Both models build the port's ``LSNet(features=True)`` with SKA plain, as
the JAX engines build theirs (without ``use_pallas_ska``). Maps are NCHW.
Module names are the JAX package's (``neck.lateral.0`` is its
``neck/lateral_0``), so ``utils/jax_bridge.py`` carries its weights
across with LSNet's key map. The BatchNorms follow the module's mode: the
JAX models differentiate only at ``train=False`` (``train=True`` needs a
mutable ``batch_stats``), so a training step that matches JAX runs them in
``eval()``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_tpu_torch.models.lsnet import LSNet, lsnet_key_map
from image_restoration_tpu_torch.models.registry import register_model
from image_restoration_tpu_torch.ops.common import Conv
from image_restoration_tpu_torch.ops.layernorm import GroupNorm
from image_restoration_tpu_torch.ops.moe import topk_lower_index
from image_restoration_tpu_torch.ops.resample import resize_bilinear


def _repeat_up(x, r: int, hw):
    """Nearest x``r`` of NCHW ``x`` (each pixel repeated r x r times),
    cropped to ``hw``."""
    x = x.repeat_interleave(r, dim=-2).repeat_interleave(r, dim=-1)
    return x[..., :hw[0], :hw[1]]


class FPN(nn.Module):
    """FPN over the backbone's stage maps (channels ``in_dims``; strides
    8/16/32/64 for LSNet), plus ``extra_levels`` stride-2 3x3 convs on the
    last output, ReLU before all but the first."""

    def __init__(self, in_dims: Sequence[int], out_dim: int = 256,
                 extra_levels: int = 2, dtype=None):
        super().__init__()
        self.lateral = nn.ModuleList(Conv(c, out_dim, 1, dtype=dtype)
                                     for c in in_dims)
        self.smooth = nn.ModuleList(Conv(out_dim, out_dim, 3, padding=1,
                                         dtype=dtype) for _ in in_dims)
        self.extra = nn.ModuleList(Conv(out_dim, out_dim, 3, 2, 1,
                                        dtype=dtype)
                                   for _ in range(extra_levels))

    def forward(self, feats):
        lat = [conv(f) for conv, f in zip(self.lateral, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + _repeat_up(lat[i], 2,
                                                  lat[i - 1].shape[-2:])
        outs = [conv(x) for conv, x in zip(self.smooth, lat)]
        x = outs[-1]
        for j, conv in enumerate(self.extra):
            x = conv(torch.relu(x) if j else x)
            outs.append(x)
        return outs


def make_anchors(sizes, strides, scales=(1.0, 2 ** (1 / 3), 2 ** (2 / 3)),
                 ratios=(0.5, 1.0, 2.0), octave_base: float = 4.0,
                 device=None):
    """xyxy anchors of every level, (sum of H * W * A, 4) fp32: per cell
    its A = len(ratios) x len(scales) boxes (ratio-major), cells
    row-major. ``sizes``: [(h, w)] per level."""
    out = []
    for (h, w), stride in zip(sizes, strides):
        base = octave_base * stride
        ws = [base * s * (1.0 / r) ** 0.5 for r in ratios for s in scales]
        hs = [base * s * r ** 0.5 for r in ratios for s in scales]
        ws = torch.tensor(ws, dtype=torch.float32, device=device)
        hs = torch.tensor(hs, dtype=torch.float32, device=device)
        cy, cx = torch.meshgrid(
            *[(torch.arange(n, dtype=torch.float32, device=device) + 0.5)
              * stride for n in (h, w)], indexing="ij")
        cx, cy = cx.reshape(-1, 1), cy.reshape(-1, 1)
        boxes = torch.stack([cx - ws / 2, cy - hs / 2, cx + ws / 2,
                             cy + hs / 2], dim=-1)  # (HW, A, 4)
        out.append(boxes.reshape(-1, 4))
    return torch.cat(out)


def box_iou(a, b):
    """IoU matrix of xyxy boxes (N, 4) x (M, 4)."""
    def area(t):
        return ((t[:, 2] - t[:, 0]).clamp_min(0)
                * (t[:, 3] - t[:, 1]).clamp_min(0))

    area_a, area_b = area(a), area(b)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp_min(1e-9)


def _centers(boxes):
    return ((boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2,
            boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])


def encode_deltas(anchors, boxes):
    """mmdet's DeltaXYWHBBoxCoder (means 0, stds 1): (dx, dy, dw, dh)."""
    ax, ay, aw, ah = _centers(anchors)
    bw = (boxes[:, 2] - boxes[:, 0]).clamp_min(1e-6)
    bh = (boxes[:, 3] - boxes[:, 1]).clamp_min(1e-6)
    bx, by = (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2
    return torch.stack([(bx - ax) / aw, (by - ay) / ah, torch.log(bw / aw),
                        torch.log(bh / ah)], dim=-1)


def decode_deltas(anchors, deltas, max_wh: float = 16.0):
    """The inverse of :func:`encode_deltas`, dw and dh clipped to
    +-``max_wh``."""
    ax, ay, aw, ah = _centers(anchors)
    bx = ax + deltas[:, 0] * aw
    by = ay + deltas[:, 1] * ah
    bw = aw * torch.exp(deltas[:, 2].clamp(-max_wh, max_wh))
    bh = ah * torch.exp(deltas[:, 3].clamp(-max_wh, max_wh))
    return torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2],
                       dim=-1)


class RetinaNetHead(nn.Module):
    """Shared towers of ``stacked`` 3x3 conv + ReLU for classes and boxes;
    ``cls_pred``'s bias starts at -log((1 - p) / p), p = 0.01. Returns the
    per-anchor class logits (B, N, classes) and deltas (B, N, 4) of every
    level, concatenated, fp32."""

    def __init__(self, num_classes: int, num_anchors: int = 9, dim: int = 256,
                 stacked: int = 4, dtype=None):
        super().__init__()
        self.num_classes, self.num_anchors = num_classes, num_anchors
        self.cls = nn.ModuleList(Conv(dim, dim, 3, padding=1, dtype=dtype)
                                 for _ in range(stacked))
        self.box = nn.ModuleList(Conv(dim, dim, 3, padding=1, dtype=dtype)
                                 for _ in range(stacked))
        self.cls_pred = Conv(dim, num_anchors * num_classes, 3, padding=1,
                             dtype=dtype)
        self.box_pred = Conv(dim, num_anchors * 4, 3, padding=1, dtype=dtype)
        with torch.no_grad():  # the focal prior, in fp32 as flax takes it
            self.cls_pred.bias.fill_(-torch.log(torch.tensor(
                (1 - 0.01) / 0.01, dtype=torch.float32)).item())

    def forward(self, feats):
        cls_out, box_out = [], []
        for f in feats:
            c = b = f
            for conv_c, conv_b in zip(self.cls, self.box):
                c, b = torch.relu(conv_c(c)), torch.relu(conv_b(b))
            n = f.shape[0]
            # (B, A * K, H, W) -> (B, H * W * A, K), the NHWC order
            cls_out.append(self.cls_pred(c).permute(0, 2, 3, 1).reshape(
                n, -1, self.num_classes))
            box_out.append(self.box_pred(b).permute(0, 2, 3, 1).reshape(
                n, -1, 4))
        return torch.cat(cls_out, 1).float(), torch.cat(box_out, 1).float()


@register_model("retinanet_lsnet", key_map=lsnet_key_map)
class RetinaNetLSNet(nn.Module):
    """LSNet backbone + FPN + RetinaNet head (LSNet-T and COCO's 80
    classes by default). ``forward(x)`` returns (class logits (B, N, K),
    deltas (B, N, 4), the six levels' (h, w)); :meth:`anchors` builds the
    anchors those sizes give."""

    def __init__(self, num_classes: int = 80,
                 embed_dim: Sequence[int] = (64, 128, 192, 256),
                 depth: Sequence[int] = (1, 2, 3, 4), img_size: int = 512,
                 fpn_dim: int = 256, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = LSNet(img_size=img_size, embed_dim=embed_dim,
                              depth=depth, num_classes=0, features=True,
                              dtype=dtype)
        self.neck = FPN(embed_dim, fpn_dim, dtype=dtype)
        self.bbox_head = RetinaNetHead(num_classes, dim=fpn_dim, dtype=dtype)

    def forward(self, x):
        feats = self.neck(self.backbone(x))
        cls, box = self.bbox_head(feats)
        return cls, box, [tuple(f.shape[-2:]) for f in feats]

    def anchor_strides(self):
        return (8, 16, 32, 64, 128, 256)

    def anchors(self, sizes, device=None):
        return make_anchors(sizes, self.anchor_strides(), device=device)


def _last_writer(index, n: int):
    """For each of ``n`` slots, the largest position p with
    ``index[p] == slot`` (-1 where none): the update that XLA's scatter
    applies last, when it applies duplicates in order."""
    pos = torch.arange(index.numel(), device=index.device)
    return torch.full((n,), -1, dtype=torch.long, device=index.device
                      ).scatter_reduce(0, index, pos, "amax")


def retinanet_loss(cls_logits, box_deltas, anchors, gt_boxes, gt_labels,
                   gt_valid, num_classes: int, alpha: float = 0.25,
                   gamma: float = 2.0, beta: float = 1.0 / 9.0):
    """One image's (focal class loss, smooth-L1 box loss), each over the
    positives' count.

    ``gt_boxes`` (G, 4) padded, ``gt_labels`` (G,), ``gt_valid`` (G,) bool.
    An anchor is positive at IoU >= 0.5 with its best box, negative below
    0.4, ignored between; every box also claims its best anchor (mmdet's
    MaxIoUAssigner). A padded slot's IoUs are 0, so its best anchor is
    anchor 0; where several slots claim one anchor the last slot decides
    it, as XLA applies JAX's ``.at[].set`` on the CPU: a valid box whose
    best anchor is 0 loses its claim to a padded slot after it."""
    iou = box_iou(anchors, gt_boxes) * gt_valid[None, :]
    best_iou = iou.max(dim=1).values
    best_gt = iou.argmax(dim=1)  # the first maximum, as jnp.argmax
    pos, neg = best_iou >= 0.5, best_iou < 0.4
    writer = _last_writer(iou.argmax(dim=0), anchors.shape[0])
    claimed = writer >= 0
    writer = writer.clamp_min(0)
    force = claimed & gt_valid[writer]
    best_gt = torch.where(force, writer, best_gt)
    pos, neg = pos | force, neg & ~force

    classes = torch.arange(num_classes, device=gt_labels.device)
    onehot = (gt_labels[best_gt][:, None] == classes).float() * pos[:, None]
    p = torch.sigmoid(cls_logits)
    ce = (cls_logits.clamp_min(0) - cls_logits * onehot
          + torch.log1p(torch.exp(-cls_logits.abs())))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    a_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    focal = a_t * (1 - p_t) ** gamma * ce
    num_pos = pos.sum().float().clamp_min(1.0)
    cls_loss = (focal * (pos | neg)[:, None]).sum() / num_pos

    d = (box_deltas - encode_deltas(anchors, gt_boxes[best_gt])).abs()
    sl1 = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return cls_loss, (sl1 * pos[:, None]).sum() / num_pos


def decode_detections(cls_logits, box_deltas, anchors, top_k: int = 200,
                      score_thr: float = 0.05, iou_thr: float = 0.5,
                      max_det: int = 100):
    """One image's detections: the top-k (anchor, class) scores (ties to
    the lower index), their decoded boxes, a class-aware greedy NMS over
    them in score order, and the ``max_det`` highest survivors. Returns
    (boxes (max_det, 4), scores (max_det,), labels (max_det,)), score 0
    where a candidate was suppressed or under ``score_thr``."""
    c = cls_logits.shape[1]
    scores = torch.sigmoid(cls_logits).reshape(-1)
    k = min(top_k, scores.shape[0])
    top_scores, flat = topk_lower_index(scores, k)
    anchor_idx, labels = flat // c, flat % c
    boxes = decode_deltas(anchors[anchor_idx], box_deltas[anchor_idx])
    suppress = (box_iou(boxes, boxes) > iou_thr) & (labels[:, None]
                                                    == labels[None, :])
    suppress &= torch.ones_like(suppress).triu(1)  # only later candidates
    keep = top_scores >= score_thr
    for i in range(k):  # each step reads the keep the earlier ones left
        keep = keep & ~(suppress[i] & keep[i])
    final = torch.where(keep, top_scores, torch.zeros_like(top_scores))
    order = torch.argsort(-final, stable=True)[:max_det]
    return boxes[order], final[order], labels[order]


@register_model("semanticfpn_lsnet", key_map=lsnet_key_map)
class SemanticFPNLSNet(nn.Module):
    """Semantic-FPN over LSNet (ADE20K's 150 classes by default): each FPN
    level through a 3x3 conv, GroupNorm(32) in fp32 and ReLU, upsampled to
    the stride-8 map (nearest, repeated), summed, a 1x1 classifier, and a
    bilinear resize to the input. Returns fp32 logits (B, classes, H, W)."""

    def __init__(self, num_classes: int = 150,
                 embed_dim: Sequence[int] = (64, 128, 192, 256),
                 depth: Sequence[int] = (1, 2, 3, 4), img_size: int = 512,
                 fpn_dim: int = 256, seg_dim: int = 128, dtype=None):
        super().__init__()
        self.backbone = LSNet(img_size=img_size, embed_dim=embed_dim,
                              depth=depth, num_classes=0, features=True,
                              dtype=dtype)
        self.neck = FPN(embed_dim, fpn_dim, extra_levels=0, dtype=dtype)
        self.scale = nn.ModuleList(Conv(fpn_dim, seg_dim, 3, padding=1,
                                        dtype=dtype) for _ in embed_dim)
        self.gn = nn.ModuleList(GroupNorm(32, seg_dim, eps=1e-6)
                                for _ in embed_dim)
        self.classifier = Conv(seg_dim, num_classes, 1, dtype=dtype)

    def forward(self, x):
        h, w = x.shape[-2:]
        feats = self.neck(self.backbone(x))
        base = feats[0].shape[-2:]
        merged = 0.0
        for i, (f, conv, gn) in enumerate(zip(feats, self.scale, self.gn)):
            g = torch.relu(gn(conv(f).float()))
            merged = merged + _repeat_up(g, 2 ** i, base)
        return resize_bilinear(self.classifier(merged).float(), h, w)


def segmentation_ce_loss(logits, labels, ignore_index: int = 255):
    """Mean cross entropy of logits (B, K, H, W) against labels (B, H, W)
    over the pixels not ``ignore_index``."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -F.log_softmax(logits, dim=1).gather(1, safe[:, None])[:, 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


def mean_iou(pred_labels, labels, num_classes: int, ignore_index: int = 255):
    """(mean IoU over the classes present in the prediction or the labels,
    the per-class IoUs with NaN for a class in neither), over the pixels
    not ``ignore_index``."""
    valid = labels != ignore_index
    p, t = pred_labels[valid].long(), labels[valid].long()
    inter = torch.bincount(t[p == t], minlength=num_classes)[:num_classes]
    union = (torch.bincount(p, minlength=num_classes)[:num_classes]
             + torch.bincount(t, minlength=num_classes)[:num_classes] - inter)
    ious = inter.float() / union.clamp_min(1).float()
    ious = torch.where(union > 0, ious, torch.full_like(ious, float("nan")))
    return torch.nanmean(ious), ious
