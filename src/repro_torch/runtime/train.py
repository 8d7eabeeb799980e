"""Training loop: data feed, train step, checkpoints, fault tolerance (the
JAX package's ``runtime/train.py``).

Crash-restart is a constructor flag: the loop resumes from the newest
committed checkpoint and re-seeds the data pipeline at the restored step
(batches are pure functions of (seed, step), so that is exact).  The
checkpoint is in the JAX package's format, so either package's loop can
resume the other's.  Parameters and AdamW state live on ``device`` (the card
unless ``"cpu"`` is asked for) and are updated in place; each batch moves
from the prefetch thread's numpy arrays to the device in the loop.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime.ft import StepWatchdog


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0
    lr: float = 3e-4
    warmup: int = 20
    ckpt_every: int = 50
    ckpt_keep: int = 2
    step_deadline_s: float = 300.0
    log_every: int = 10


class TrainLoop:
    def __init__(self, cfg: ModelConfig, run: TrainLoopConfig,
                 ckpt_dir: Optional[Path] = None, *,
                 resume: bool = False,
                 on_log: Optional[Callable[[Dict[str, Any]], None]] = None,
                 shell=None, region: Optional[int] = None,
                 straggler_stats=None, device=None):
        self.cfg = cfg
        self.run = run
        self.model = build_model(cfg, device=device)
        self.device = self.model.device
        self.opt = AdamW(lr=cosine_schedule(run.lr, run.warmup, run.steps))
        self.on_log = on_log or (lambda rec: None)
        # With a Shell attached, blown step deadlines surface as
        # WatchdogTimeout events on the shell's bus.
        self.shell = shell
        self.watchdog = StepWatchdog(run.step_deadline_s, shell=shell)
        # Fleet straggler detection: a StragglerStats shared across the
        # fleet's loops (each records its own ``region``); a persistent
        # straggler posts WatchdogTimeout through the shell.  ``region``
        # also attributes blown step deadlines to this loop's region.
        self.region = region
        self.straggler_stats = straggler_stats
        if (straggler_stats is not None and straggler_stats.shell is None
                and shell is not None):
            straggler_stats.shell = shell
        self.ckpt = (CheckpointManager(ckpt_dir, keep=run.ckpt_keep)
                     if ckpt_dir is not None else None)
        self.history: List[Dict[str, Any]] = []

        self.pipeline = DataPipeline(
            seed=run.seed, global_batch=run.global_batch,
            seq_len=run.seq_len, vocab=cfg.vocab, kind="train")
        self._step_fn = make_train_step(self.model, self.opt)

        # --- init or resume -------------------------------------------
        gen = torch.Generator(device=self.device)
        gen.manual_seed(run.seed)
        self.params = self.model.init(gen)
        self.opt_state = self.opt.init(self.params)
        self.start_step = 0
        if resume and self.ckpt is not None:
            got = self.ckpt.restore_latest((self.params, self.opt_state))
            if got is not None:
                self.start_step, (self.params, self.opt_state) = got
        self.pipeline.restore(
            dataclasses.replace(self.pipeline.state(), step=self.start_step))

    # ------------------------------------------------------------------
    def probe(self):
        """A ``repro_torch.manager`` telemetry probe over this loop's fleet
        straggler statistics (requires ``straggler_stats=``)."""
        if self.straggler_stats is None:
            raise ValueError("TrainLoop.probe() needs straggler_stats=")
        return self.straggler_stats.probe()

    # ------------------------------------------------------------------
    def run_loop(self) -> List[Dict[str, Any]]:
        run = self.run
        self.pipeline.start()
        try:
            for step in range(self.start_step, run.steps):
                self.watchdog.arm(step)
                t0 = time.monotonic()
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in next(self.pipeline).items()}
                self.params, self.opt_state, loss = self._step_fn(
                    self.params, self.opt_state, batch)
                loss = float(loss)
                dt = time.monotonic() - t0
                self.watchdog.check(region=self.region)
                if (self.straggler_stats is not None
                        and self.region is not None):
                    # no region identity -> nothing to attribute
                    self.straggler_stats.record(self.region, dt)
                    self.straggler_stats.sweep(step=step)

                if step % run.log_every == 0 or step == run.steps - 1:
                    rec = {"step": step, "loss": loss, "step_s": dt}
                    self.history.append(rec)
                    self.on_log(rec)
                if np.isnan(loss):
                    raise FloatingPointError(f"NaN loss at step {step}")
                if self.ckpt is not None and (step + 1) % run.ckpt_every == 0:
                    self.ckpt.save_async(step + 1,
                                         (self.params, self.opt_state),
                                         extra={"loss": loss})
        finally:
            self.pipeline.stop()
            if self.ckpt is not None:
                self.ckpt.wait()
        return self.history
