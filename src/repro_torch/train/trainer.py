"""Fault-tolerant training loop.

The counterpart of ``repro/train/trainer.py``, with its loop:
  * checkpoint/restart: asynchronous atomic checkpoints every
    ``ckpt_every`` steps; ``Trainer.fit`` resumes from the latest one
    (parameters, optimizer, data-stream position) after a crash or a
    preemption.
  * NaN/Inf rollback: a non-finite loss restores the last good
    checkpoint and skips the data past the poisoned batch window.
  * preemption: SIGTERM/SIGINT set a flag; the loop checkpoints and exits
    at the next step boundary.
  * straggler accounting: a per-step deadline (EMA x factor, the EMA
    starting at the second step, since the first carries the warm-up);
    a missed deadline calls a pluggable callback and is counted.
  * elastic restart: checkpoints restore onto the device of the state
    passed to ``fit``, whichever device saved them.
The loss is read to the host once a step (the reference's
``float(jax.device_get(...))``), the loop's one wait for the device.
The train steps update the state in place, so a rollback replaces the
state with the checkpoint's tensors, and a checkpoint snapshot is a copy.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import signal
import tempfile
import time
from typing import Callable, Optional

from repro_torch.data.synthetic import SyntheticTokenStream

from . import checkpoint as ckpt

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    nan_rollback: bool = True
    max_rollbacks: int = 3
    skip_on_rollback: int = 1       # batches to skip past a loss spike
    straggler_factor: float = 3.0   # deadline = factor x EMA(step time)
    straggler_warmup: int = 10


class Trainer:
    def __init__(self, step_fn: Callable, data: SyntheticTokenStream,
                 cfg: TrainerConfig,
                 straggler_cb: Optional[Callable[[int, float], None]] = None):
        self.step_fn = step_fn
        self.data = data
        self.cfg = cfg
        self.straggler_cb = straggler_cb or (lambda step, t: None)
        self.saver = ckpt.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.preempted = False
        self.rollbacks = 0
        self.straggler_events = 0
        self.metrics_history: list = []

    # -- preemption -------------------------------------------------------
    def install_signal_handlers(self):
        def handler(signum, frame):
            log.warning("preemption signal %s: checkpoint at next step",
                        signum)
            self.preempted = True
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    # -- main loop ----------------------------------------------------------
    def fit(self, state, *, resume: bool = True):
        cfg = self.cfg
        start_step = 0
        if resume and ckpt.latest_step(cfg.ckpt_dir) is not None:
            state, extra = ckpt.restore(cfg.ckpt_dir, state)
            start_step = int(extra["train_step"])
            self.data.step = int(extra["data_step"])
            log.info("resumed at step %d", start_step)

        ema = None
        step = start_step
        while step < cfg.total_steps and not self.preempted:
            t0 = time.perf_counter()
            batch = self.data.next_batch()
            new_state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0

            if not math.isfinite(loss) and cfg.nan_rollback:
                state, step = self._rollback(state, step)
                continue

            state = new_state
            step += 1
            self.metrics_history.append({"step": step, "loss": loss,
                                         "time_s": dt})
            if step % cfg.log_every == 0 or step == cfg.total_steps:
                log.info("step %d loss %.4f (%.0f ms)", step, loss, dt * 1e3)

            # straggler deadline (EMA starts at the SECOND step: the first
            # carries the warm-up and would poison the baseline)
            if step - start_step >= 2:
                if ema is None:
                    ema = dt
                elif step - start_step > cfg.straggler_warmup and \
                        dt > cfg.straggler_factor * ema:
                    self.straggler_events += 1
                    self.straggler_cb(step, dt)
                ema = 0.9 * ema + 0.1 * dt

            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                self._save(step, state)

        if self.preempted:
            self._save(step, state)
        self.saver.wait()
        return state, step

    # -- internals ----------------------------------------------------------
    def _save(self, step, state):
        self.saver.save(step, state, extra={
            "train_step": step, "data_step": self.data.step})

    def _rollback(self, state, step):
        self.rollbacks += 1
        if self.rollbacks > self.cfg.max_rollbacks:
            raise RuntimeError("too many NaN rollbacks: aborting")
        # Flush any in-flight async save BEFORE probing the directory: the
        # last good checkpoint may still be in the writer thread.
        self.saver.wait()
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is None:
            raise RuntimeError("non-finite loss before first checkpoint")
        state, extra = ckpt.restore(self.cfg.ckpt_dir, state)
        restored = int(extra["train_step"])
        # Skip past the poisoned data window.
        self.data.step = int(extra["data_step"]) + self.cfg.skip_on_rollback \
            + (step - restored)
        log.warning("non-finite loss at step %d -> rolled back to %d, "
                    "data skipped to %d", step, restored, self.data.step)
        return state, restored
