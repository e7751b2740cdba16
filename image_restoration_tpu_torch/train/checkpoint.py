"""Checkpoints on ``torch.save`` (image_restoration_tpu/train/checkpoint.py,
which uses orbax).

Reproduced behaviors (SURVEY.md §5 checkpoint/resume):
* periodic saves every N steps, and a forced save (Lightning
  ModelCheckpoint semantics, MoCE-IR-main/src/train.py:116);
* save-best-by-val-PSNR with a ``best`` pointer file (NeRD-Rain
  train.py:190-196 et al.);
* auto-resume: scan the checkpoint directory for the newest step
  (BasicSR settingI/basicsr/train.py:180-201);
* EMA stored beside the raw parameters (BasicSR params/params_ema).

A checkpoint is ``<dir>/<step>.pth``: a dict with ``step``, ``params`` (the
model's flat state_dict), ``params_ema`` (with EMA), ``opt_state`` and
``metrics``. ``utils/torch_import.py`` ``unwrap_checkpoint`` reads its
``params`` or, with ``prefer_ema``, its ``params_ema``, so ``cli/test.py
--ckpt`` and ``cli/infer.py --ckpt`` score it, and the JAX package's own
``.pth`` import reads it too. ``save_every`` 0 means no periodic saves:
only forced ones (``should_save``), where the JAX manager's ``save`` would
save every call it gets (``ADVICE.md``).
"""

from __future__ import annotations

import math
import os
import re
from typing import Optional

import torch

_CKPT = re.compile(r"^(\d+)\.pth$")


class CheckpointManager:
    def __init__(self, directory: str, save_every: int = 1000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_every = save_every
        self.best_psnr = -math.inf

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pth")

    def steps(self):
        return sorted(int(m.group(1)) for n in os.listdir(self.directory)
                      if (m := _CKPT.match(n)))

    def should_save(self, step: int) -> bool:
        """A periodic save is due at ``step`` (never with ``save_every`` 0)."""
        return bool(self.save_every) and step % self.save_every == 0

    def save(self, step: int, state, metrics: Optional[dict] = None,
             force: bool = False) -> bool:
        """Write ``state`` (a ``TrainState``) at ``step`` if ``force`` or a
        periodic save is due; returns whether it wrote."""
        if not force and not self.should_save(step):
            return False
        tmp = self.path(step) + ".tmp"
        torch.save({**state.state_dict(), "metrics": metrics or {}}, tmp)
        os.replace(tmp, self.path(step))
        return True

    def maybe_save_best(self, step: int, state, psnr: float) -> bool:
        """save-best-by-val-PSNR: keeps a 'best' pointer file + checkpoint."""
        if psnr > self.best_psnr:
            self.best_psnr = float(psnr)
            self.save(step, state, metrics={"psnr": float(psnr)}, force=True)
            with open(os.path.join(self.directory, "best"), "w") as f:
                f.write(f"{step} {psnr:.4f}\n")
            return True
        return False

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None):
        """Auto-resume from the newest step (BasicSR .state scan analog):
        loads into ``state`` (its model, optimizer state and EMA, in place)
        and returns ``(state, step)``, or ``(None, None)`` when there is no
        checkpoint."""
        raw, step = self.restore_raw(step)
        if raw is None:
            return None, None
        return state.load_state_dict(raw), step

    def restore_raw(self, step: Optional[int] = None):
        """The checkpoint dict on the host CPU (no template needed), and its
        step; ``(None, None)`` when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True), step
