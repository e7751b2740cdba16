"""Observability: message logger, meters, timers, parameter counts
(image_restoration_tpu/utils/logging.py).

Replaces the zoo's scattered loggers (BasicSR MessageLogger, W&B/TB Lightning
loggers, tee stdout logs at 20260104_CG_IR/src/train.py:25-35, NeRD
get_parameter_number.py, the remaining-time estimator of SRConvNet
custom/caltime.py). ``metrics.jsonl`` holds the JAX package's records.
Profiling: :func:`cost_analysis` counts FLOPs with torch's
``FlopCounterMode`` in place of XLA's cost analysis, :func:`profile_trace`
records a ``torch.profiler`` trace in place of ``jax.profiler``'s, and
:class:`CloudLog` is the JAX module's fire-and-forget HTTP sender.
"""

from __future__ import annotations

import contextlib
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


def cost_analysis(fn, *args) -> dict:
    """FLOPs of one call ``fn(*args)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` -- the fvcore
    FlopCountAnalysis / ptflops replacement (moce_ir.py:1086-1088) and the
    port's counterpart of the JAX module's XLA cost analysis.

    The counter sees the operators torch dispatches and counts matrix
    products, convolutions and attention at 2 FLOPs a multiply-add, every
    tap of a padded convolution included (XLA counts only the taps inside
    the input, so the two agree on unpadded convolutions); elementwise
    operations, reductions and normalisations count 0, where XLA counts
    them too. A kernel launched through ctypes is invisible to
    it, so count on the model as built for the CPU, whose kernel wrappers
    run their plain versions (the same products). torch has no
    bytes-accessed figure, so there is no ``bytes_accessed`` key. (JAX's
    returns ``{}`` where the compiled program has no cost analysis; the
    counter always has its count.)"""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` over the block, on the CPU and, where there is
    one, the CUDA device; the Chrome trace goes to
    ``logdir/trace_<pid>_<ms>.json`` when the block ends (the
    ``jax.profiler`` trace context's counterpart). Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))


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


class CloudLog:
    """Fire-and-forget HTTP log sender (SRConvNet custom/serverLog.py:10-36
    LogClass analog, gated by the train CLI's --cloudlog flag); a copy of
    the JAX module's.

    Posts `name`/`content` as URL-quoted query params to `url` from a single
    daemon worker draining a bounded queue (a slow endpoint can neither pile
    up threads nor serialize the training loop; overflow drops the oldest
    pending entry). Network failures are swallowed (the reference prints and
    continues). Off (or an empty url) makes sendLog a no-op -- the default.
    """

    def __init__(self, on: bool = False, url: str = "", timeout: float = 5.0,
                 max_pending: int = 64):
        self.on = on and bool(url)
        self.url = url
        self.timeout = timeout
        self._q = None
        if self.on:
            import queue
            import threading

            self._q = queue.Queue(maxsize=max_pending)
            threading.Thread(target=self._worker, daemon=True).start()

    def _worker(self) -> None:
        from urllib.parse import quote
        from urllib.request import urlopen

        while True:
            content, name = self._q.get()
            try:
                sep = "&" if "?" in self.url else "?"
                full = (f"{self.url}{sep}name={quote(name, 'utf-8')}"
                        f"&content={quote(content, 'utf-8')}")
                urlopen(full, timeout=self.timeout).read()
            except Exception:  # the reference prints and goes on
                print("\nsendLog network error!")

    def sendLog(self, content: str, name: str) -> None:
        if not self.on:
            return
        import queue

        try:
            self._q.put_nowait((content, name))
        except queue.Full:  # drop the oldest, keep the newest
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                self._q.put_nowait((content, name))
            except queue.Full:
                pass
