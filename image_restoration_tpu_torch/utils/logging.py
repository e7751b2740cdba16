"""Observability: message logger, meters, timers, parameter counts
(image_restoration_tpu/utils/logging.py).

Replaces the zoo's scattered loggers (BasicSR MessageLogger, W&B/TB Lightning
loggers, tee stdout logs at 20260104_CG_IR/src/train.py:25-35, NeRD
get_parameter_number.py, the remaining-time estimator of SRConvNet
custom/caltime.py). ``metrics.jsonl`` holds the JAX package's records.
The JAX module's XLA ``cost_analysis``, ``profile_trace`` and its network
``CloudLog`` are not here (ROADMAP Queue 1 item 6); ``chip_smoke.py
--profile`` traces the card with ``torch.profiler``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Mapping


class TeeLogger:
    """Mirror stdout to a log file (CG-IR train.py:25-35 behavior)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.file = open(path, "a")
        self.stdout = sys.stdout

    def write(self, msg):
        self.stdout.write(msg)
        self.file.write(msg)

    def flush(self):
        self.stdout.flush()
        self.file.flush()

    def install(self):
        sys.stdout = self
        return self

    def close(self):
        if sys.stdout is self:
            sys.stdout = self.stdout
        self.file.close()


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.n = 0

    def update(self, v, k: int = 1):
        self.sum += float(v) * k
        self.n += k

    @property
    def avg(self):
        return self.sum / max(self.n, 1)


class Timer:
    """Wall-clock timer + ETA estimator (caltime.py / val_utils.timer analog)."""

    def __init__(self, total_steps: int | None = None):
        self.t0 = time.perf_counter()
        self.total = total_steps
        self.last = self.t0

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        return dt

    def eta(self, step: int) -> float:
        if not self.total or step == 0:
            return float("nan")
        elapsed = time.perf_counter() - self.t0
        return elapsed / step * (self.total - step)


def count_params(params) -> int:
    """NeRD-Rain get_parameter_number.py analog: the elements of a module's
    parameters, or of a mapping of tensors."""
    tensors = params.values() if isinstance(params, Mapping) else \
        params.parameters()
    return sum(t.numel() for t in tensors)


def model_summary(model, max_depth: int = 2) -> str:
    """Per-module parameter table (MoCE-IR-main/src/utils/model_summary.py
    and NeRD-Rain get_parameter_number.py analog): aggregates parameter
    sizes up to ``max_depth`` levels of the JAX tree (digit segments merged
    into their parent, as the weight bridge maps them) and prints counts +
    MB."""
    rows: dict = {}
    for name, p in model.named_parameters():
        segs = []
        for s in name.split(".")[:-1]:
            if segs and s.isdigit():
                segs[-1] = f"{segs[-1]}_{s}"
            else:
                segs.append(s)
        key = "/".join((segs or [name])[:max_depth])
        rows[key] = rows.get(key, 0) + p.numel()
    total = sum(rows.values())
    width = max((len(k) for k in rows), default=10)
    lines = [f"{'module':<{width}}  {'params':>12}  {'MB(fp32)':>9}"]
    for k in sorted(rows):
        lines.append(f"{k:<{width}}  {rows[k]:>12,}  {rows[k]*4/1e6:>9.2f}")
    lines.append(f"{'TOTAL':<{width}}  {total:>12,}  {total*4/1e6:>9.2f}")
    return "\n".join(lines)


class MessageLogger:
    """Console/JSONL logger (BasicSR MessageLogger analog); optional TB/W&B
    sinks are attached only if available and requested. ``log`` reads each
    value with ``float()``: on the card that waits for it, so the trainer
    logs only every ``log_every`` steps."""

    def __init__(self, exp_dir: str, total_steps: int | None = None,
                 use_tb: bool = False, use_wandb: bool = False):
        os.makedirs(exp_dir, exist_ok=True)
        self.jsonl = open(os.path.join(exp_dir, "metrics.jsonl"), "a")
        self.timer = Timer(total_steps)
        self.tb = None
        self.wandb = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(exp_dir, "tb"))
            except ImportError:
                pass
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb
            except ImportError:
                pass

    def log(self, step: int, scalars: dict[str, Any], prefix: str = "train"):
        values = {k: float(v) for k, v in scalars.items()}
        rec = {"step": step, **{f"{prefix}/{k}": v for k, v in values.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb:
            for k, v in values.items():
                self.tb.add_scalar(f"{prefix}/{k}", v, step)
        if self.wandb and getattr(self.wandb, "run", None):
            self.wandb.log(rec, step=step)
        eta = self.timer.eta(step)
        msg = " ".join(f"{k}={v:.4g}" for k, v in values.items())
        print(f"[{prefix}] step {step} {msg} eta={eta/60:.1f}min" if eta == eta
              else f"[{prefix}] step {step} {msg}")

    def close(self):
        self.jsonl.close()
        if self.tb:
            self.tb.close()
