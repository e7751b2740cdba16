"""Offline feature distillation (image_restoration_tpu/train/distill.py).

Reference: ``20260202_Offline_distill/`` -- teacher->student feature
distillation for classification backbones:

* loss (train.py:173-186): both features L2-normalised; a cosine term
  ``1 - mean(sum(f_s * f_t))`` plus an MSE term on the normalised
  features, each with a config weight (:func:`feature_distill_loss`);
* freeze strategies (freeze_strategy.py): freeze named layer groups /
  everything except the last layers / a ratio of leading layers
  (:func:`freeze_mask`), applied by :func:`frozen_optimizer` as optax's
  ``multi_transform`` with ``set_to_zero`` applies the JAX mask;
* export (pth2onnx.py): the deployment hand-off. JAX serialises StableHLO;
  the port serialises a ``torch.export`` program (:func:`export_program`,
  :func:`load_program`). A kernel launched through ctypes cannot be
  traced, and exporting would record its plain version in its place, so
  those wrappers raise under export (``kernels/build.py``
  ``refuse_export``); SKA (K9) is a custom op, and an LSNet built with
  ``use_pallas_ska`` exports with its kernel inside.
"""

from __future__ import annotations

import io
import os
import re
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch


def feature_distill_loss(student_feat, teacher_feat, cos_weight: float = 1.0,
                         l2_weight: float = 1.0, eps: float = 1e-12):
    """train.py:173-186: cosine + MSE on L2-normalised (B, D) feature
    vectors, in fp32. Returns (total, logs)."""
    s, t = student_feat.float(), teacher_feat.float()
    f = s / torch.clamp(torch.linalg.vector_norm(s, dim=1, keepdim=True),
                        min=eps)
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=1, keepdim=True),
                        min=eps)
    cos = (1.0 - torch.mean(torch.sum(f * t, dim=1))) * cos_weight
    l2 = torch.mean((f - t) ** 2) * l2_weight
    return cos + l2, {"distill_cos_loss": cos, "distill_l2_loss": l2}


def jax_path(name: str, key_map: Optional[Callable] = None) -> str:
    """The JAX tree path of a torch parameter name, '/'-joined: the key
    map's rewrite (the weight bridge's, e.g. ``lsnet_key_map``), then each
    digit segment merged into its parent (``blocks1.0`` -> ``blocks1_0``),
    as ``utils/jax_bridge.py`` walks it. The leaf keeps its torch name
    (``weight`` where JAX has ``kernel`` or ``scale``)."""
    key = name if key_map is None else (key_map(name) or name)
    out = []
    for seg in key.split("."):
        if out and re.fullmatch(r"\d+", seg):
            out[-1] = f"{out[-1]}_{seg}"
        else:
            out.append(seg)
    return "/".join(out)


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def freeze_mask(params, strategy: str = "freeze_all_except_last_layers",
                frozen_layers: Sequence[str] = (),
                freeze_ratio: float = 0.8,
                last_layers: Sequence[str] = ("head", "fc"),
                key_map: Optional[Callable] = None) -> Dict[str, bool]:
    """{parameter name: True = trainable} (freeze_strategy.py strategies),
    for a module's ``named_parameters()`` (or a name -> tensor mapping),
    decided on each parameter's JAX path (:func:`jax_path` through
    ``key_map``), so the strategies pick what the JAX ones pick.

    * 'freeze_layers': freeze any parameter whose path contains one of
      ``frozen_layers``;
    * 'freeze_all_except_last_layers': only paths containing one of
      ``last_layers`` train;
    * 'freeze_ratio': the first ``ratio`` fraction of the sorted top-level
      names freeze (JAX sorts the tree's keys).
    """
    paths = {k: jax_path(k, key_map) for k in _named(params)}
    if strategy == "freeze_layers":
        return {k: not any(f in p for f in frozen_layers)
                for k, p in paths.items()}
    if strategy == "freeze_all_except_last_layers":
        return {k: any(t in p for t in last_layers) for k, p in paths.items()}
    if strategy == "freeze_ratio":
        top = sorted({p.split("/")[0] for p in paths.values()})
        frozen = set(top[:int(len(top) * freeze_ratio)])
        return {k: p.split("/")[0] not in frozen for k, p in paths.items()}
    raise ValueError(f"unknown freeze strategy {strategy!r}")


class FrozenOptimizer:
    """An optimizer (``train/trainer.py`` ``Optimizer``) over the
    trainable parameters alone; the frozen ones get zero updates, no
    weight decay and no moments: optax's ``multi_transform({"train": tx,
    "frozen": set_to_zero()})``. The inner optimizer's global-norm clip
    sees the trainable gradients only, as in optax. Same interface as the
    optimizer: ``init(params)``, ``update(grads, state, params)``, where
    ``grads`` needs only the trainable entries."""

    def __init__(self, tx, mask: Mapping[str, bool]):
        self.tx, self.mask = tx, dict(mask)

    def trainable(self, names):
        return [k for k in names if self.mask[k]]

    def init(self, params):
        return self.tx.init({k: params[k] for k in self.trainable(params)})

    def update(self, grads, state, params):
        train = self.trainable(params)
        updates, state = self.tx.update({k: grads[k] for k in train}, state,
                                        {k: params[k] for k in train})
        if updates is None:   # a micro-step of gradient accumulation
            return None, state
        return {k: updates[k] if self.mask[k] else torch.zeros_like(p)
                for k, p in params.items()}, state


def frozen_optimizer(tx, mask: Mapping[str, bool]) -> FrozenOptimizer:
    """Wrap an optimizer so masked-out (False) parameters receive zero
    updates -- requires_grad=False + param groups, in optax's terms."""
    return FrozenOptimizer(tx, mask)


def make_distill_step(student, teacher, tx: FrozenOptimizer,
                      cos_weight: float = 1.0, l2_weight: float = 1.0):
    """``step(images) -> logs``: the teacher's features in eval mode
    without gradients, the student's in train mode, the
    :func:`feature_distill_loss`, its gradients in the trainable
    parameters alone (autograd stops below the lowest of them) and
    ``tx``'s update, applied in place. ``tx.init`` runs on the first
    call; ``step.state`` holds the optimizer state."""
    params = dict(student.named_parameters())
    train = tx.trainable(params)

    def step(images):
        teacher.eval()
        student.train()
        if step.state is None:
            step.state = tx.init(params)
        with torch.no_grad():
            t = teacher(images)
        total, logs = feature_distill_loss(student(images), t, cos_weight,
                                           l2_weight)
        grads = dict(zip(train, torch.autograd.grad(
            total, [params[k] for k in train])))
        updates, step.state = tx.update(grads, step.state, params)
        if updates is not None:
            with torch.no_grad():
                torch._foreach_add_(list(params.values()),
                                    [updates[k] for k in params])
        logs["total"] = total
        return {k: v.detach() for k, v in logs.items()}

    step.state = None
    return step


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(model, args, path: str | None = None) -> bytes:
    """Serialise the forward of ``model`` (a module, or a function of
    tensors) on ``args`` to ``torch.export`` bytes, written to ``path``
    too when given (the pth2onnx.py deployment analog). Traced in eval
    mode under ``torch.no_grad()``; raises where the forward launches a
    kernel that cannot be traced (module docstring)."""
    module = model if isinstance(model, torch.nn.Module) else _Fn(model)
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(module, tuple(args))
    finally:
        module.train(was_training)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_program(blob):
    """The module of an exported program, from :func:`export_program`'s
    bytes or a path to them; it runs the exported graph (SKA's custom op
    is registered first)."""
    import image_restoration_tpu_torch.kernels.ska  # noqa: F401  (ir_torch::ska)

    src = io.BytesIO(blob) if isinstance(blob, (bytes, bytearray)) else blob
    if not isinstance(src, io.BytesIO) and not os.path.exists(src):
        raise FileNotFoundError(src)
    return torch.export.load(src).module()
