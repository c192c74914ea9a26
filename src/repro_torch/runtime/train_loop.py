"""Fault-tolerant training loop (counterpart of the JAX package's
``runtime/train_loop.py``):

  * periodic atomic checkpoints (params, opt, data cursor) and automatic
    resume from the newest intact step;
  * deterministic data skipping on resume (the cursor is part of the
    checkpoint, so a killed-and-restarted run replays the same batches);
  * straggler watchdog: EMA of step wall-time; steps slower than
    ``straggler_factor`` x EMA are logged and counted;
  * crash injection for tests (``crash_at_step``).

The model is updated in place (``runtime.trainer``); a resume copies the
checkpoint's parameters into it.  Each step's time ends when its loss is
ready on the device (the reference's ``block_until_ready``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..checkpoint import Checkpointer, latest_step
from ..models.specs import tree_leaves


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    crash_at_step: Optional[int] = None      # fault-injection (tests)


class StragglerWatchdog:
    def __init__(self, factor: float):
        self.factor = factor
        self.ema = None
        self.flagged = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.flagged.append((step, dt, self.ema))
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        return slow


def _block_until_ready(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def _scalar(v) -> float:
    """A metric as a float (a ``DTensor`` metric is read whole)."""
    return float(v.full_tensor() if hasattr(v, "full_tensor") else v)


def run(step_fn: Callable, model, opt, batch_iter_fn: Callable,
        cfg: LoopConfig, log_fn=print):
    """batch_iter_fn(cursor) -> (batch, new_cursor).  Returns (model, opt,
    {"metrics": [per step {name: float}], "stragglers": [...]}).

    Resumes from the newest intact checkpoint in cfg.ckpt_dir if present.
    """
    ckpt = Checkpointer(cfg.ckpt_dir)
    start, cursor = 0, 0
    if latest_step(cfg.ckpt_dir) is not None:
        (params, opt), start, extra = ckpt.restore((model.tree(), opt))
        with torch.no_grad():
            for p, q in zip(tree_leaves(model.tree()), tree_leaves(params)):
                p.copy_(q)
        cursor = extra.get("cursor", 0)
        log_fn(f"[resume] restored step {start} cursor {cursor}")
    dog = StragglerWatchdog(cfg.straggler_factor)
    metrics_hist = []
    for step in range(start, cfg.total_steps):
        if cfg.crash_at_step is not None and step == cfg.crash_at_step:
            raise RuntimeError(f"injected crash at step {step}")
        batch, cursor = batch_iter_fn(cursor)
        t0 = time.perf_counter()
        model, opt, metrics = step_fn(model, opt, batch)
        _block_until_ready(metrics["loss"])
        dt = time.perf_counter() - t0
        slow = dog.observe(step, dt)
        metrics_hist.append({k: _scalar(v) for k, v in metrics.items()})
        if step % cfg.log_every == 0 or slow:
            log_fn(f"[step {step}] loss={_scalar(metrics['loss']):.4f} dt={dt*1e3:.1f}ms"
                   + (" STRAGGLER" if slow else ""))
        if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.total_steps:
            ckpt.save(step + 1, (model.tree(), opt), {"cursor": int(cursor)})
    return model, opt, {"metrics": metrics_hist, "stragglers": dog.flagged}
