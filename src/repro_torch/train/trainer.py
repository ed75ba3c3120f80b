"""Training loop with checkpoint/restart and a straggler watchdog.

Counterpart of ``repro/train/trainer.py``:

* **Crash/restart**: every ``ckpt_every`` steps, and at the last step, the
  whole train state is written atomically (``train/checkpoint.py``); on
  start the trainer resumes from the newest readable checkpoint. The data
  is stateless in ``(seed, step)``, so a resume replays the same batches.
* **Stragglers**: each step's wall time is set against the median of the
  trailing 32 (from 8 steps on); a step slower than ``straggler_factor``
  times it is counted.
* **Elastic scaling**: ``train/elastic.py`` re-places a state between
  steps.

The default step is ``make_train_step(...)`` itself (``repro`` jits it and
donates the state). The clock is this module's ``time`` (a test replaces
it).
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch import convert, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.steps import init_train_state, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    num_microbatches: int = 1
    peak_lr: float = 3e-4
    straggler_factor: float = 3.0
    log_every: int = 10
    seed: int = 0


@dataclass
class Trainer:
    cfg: ModelConfig
    tcfg: TrainerConfig
    batch_fn: Callable[[int], Any]  # step -> batch dict (stateless/seekable)
    step_fn: Optional[Callable] = None
    state: Any = None
    step_times: list = field(default_factory=list)
    straggler_events: int = 0
    # test hook: callable(step) -> extra delay seconds (simulates stragglers)
    delay_injector: Optional[Callable[[int], float]] = None
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.step_fn is None:
            self.step_fn = make_train_step(
                self.cfg, num_microbatches=self.tcfg.num_microbatches,
                peak_lr=self.tcfg.peak_lr)

    # -- lifecycle ---------------------------------------------------------

    def init_or_resume(self) -> int:
        """Restore the newest readable checkpoint (the port's or
        ``repro``'s layout) onto the device, or draw a fresh state from
        ``tcfg.seed``. Returns the step to start from."""
        restored = ckpt_lib.restore(self.tcfg.ckpt_dir, device=self.device)
        if restored is not None:
            state, step = restored
            self.state = convert.train_state(state, self.cfg,
                                             device=self.device)
            return int(step)
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        self.state = init_train_state(gen, self.cfg, device=self.device)
        return 0

    def _watch(self, dt: float):
        self.step_times.append(dt)
        window = self.step_times[-32:]
        if len(window) >= 8:
            med = statistics.median(window[:-1])
            if dt > self.tcfg.straggler_factor * med:
                self.straggler_events += 1

    # -- main loop ----------------------------------------------------------

    def run(self) -> dict:
        start = self.init_or_resume()
        metrics = {}
        for step in range(start, self.tcfg.total_steps):
            t0 = time.time()
            if self.delay_injector is not None:
                time.sleep(self.delay_injector(step))
            batch = self.batch_fn(step)
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            self._watch(time.time() - t0)
            if ((step + 1) % self.tcfg.ckpt_every == 0
                    or step + 1 == self.tcfg.total_steps):
                ckpt_lib.save(self.tcfg.ckpt_dir, step + 1, self.state,
                              keep=self.tcfg.keep)
            if (step + 1) % self.tcfg.log_every == 0:
                print(
                    f"step {step + 1}: loss={metrics.get('loss', float('nan')):.4f}"
                    f" grad_norm={metrics.get('grad_norm', float('nan')):.3f}"
                    f" stragglers={self.straggler_events}",
                    flush=True,
                )
        return metrics
