"""Fault-tolerant training loop (port of ``repro.train.loop``).

- **Checkpoint / restart**: ``run`` first restores the latest checkpoint
  under ``ckpt_dir`` if there is one, then saves every ``ckpt_every``
  steps, at the end, and when SIGTERM (a preemption notice) arrives. The
  data pipeline is indexed by step, so the restored integer step is the
  whole iterator state and a resumed run repeats the uninterrupted one.
- **Straggler watchdog**: each step's wall time is held against the median
  of the last 50 (floored at ``straggler_floor_s``); a step slower than
  ``straggler_factor`` x that median is counted and passed to
  ``on_straggler(step, ratio)``. A flagged step's time stays out of the
  median, unless 3 steps in a row are flagged: that is a change of regime,
  and the baseline then adapts.
- **Metrics**: one JSON line per step (the step's metrics, ``step``,
  ``wall_s``, ``stragglers``); ``run`` returns the final step, p50 / p99
  of the step times, the straggler count and ``preempted``.

A step's wall time ends on a host read of its loss, where the reference
blocks until the loss is ready: the step's work on the card is then done.

Sharded (``run(..., shardings=layout)``, a ``models.common.TrainLayout``
of the local shards the step takes): checkpoints hold the global leaves
(``layout.dtensors`` views; rank 0 writes) and a restore puts them onto
this run's mesh, whatever mesh saved them. All ranks resume from the step
rank 0 finds and stop on rank 0's preemption notice; only rank 0 writes
the log. The watchdog reads each rank's
own step time.
"""
from __future__ import annotations

import dataclasses
import json
import signal
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import (
    latest_step, restore_checkpoint, save_checkpoint)

__all__ = ["TrainLoop"]


@dataclasses.dataclass
class TrainLoop:
    train_step: Callable                 # (params, opt, batch) -> (params, opt, metrics)
    data_fn: Callable[[int], dict]       # step -> batch (stateless)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep_n: int = 3
    log_path: Optional[str] = None
    straggler_factor: float = 3.0
    straggler_floor_s: float = 0.01
    on_straggler: Optional[Callable[[int, float], None]] = None

    def run(self, params, opt_state, num_steps: int, *, start_step: int = 0,
            shardings=None):
        """Run up to ``num_steps`` total steps; resumes from checkpoints.
        Returns (params, opt_state, info)."""
        step = start_step
        lead = True                          # writes the log
        latest = latest_step(self.ckpt_dir) if self.ckpt_dir else None
        if shardings is not None:
            import torch.distributed as dist
            lead = dist.get_rank() == 0
            agreed = [latest]
            dist.broadcast_object_list(agreed, src=0)
            latest = agreed[0]
        if latest is not None:
            tree = (params, opt_state)
            if shardings is not None:
                tree = shardings.dtensors(tree)
            (params, opt_state), extras = restore_checkpoint(
                self.ckpt_dir, latest, tree)
            if shardings is not None:
                params, opt_state = shardings.local((params, opt_state))
            step = int(extras["step"]) + 1

        preempted = {"flag": False}

        def _sigterm(signum, frame):       # preemption notice
            preempted["flag"] = True

        prev_handler = signal.signal(signal.SIGTERM, _sigterm)
        times: list = []       # every step (final p50 / p99)
        window: list = []      # outlier-excluded (straggler median)
        stragglers = 0
        consec_outliers = 0
        log_f = open(self.log_path, "a") if self.log_path and lead else None
        try:
            while step < num_steps:
                t0 = time.monotonic()
                batch = self.data_fn(step)
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch)
                rec = {k: float(v) for k, v in metrics.items()}
                dt = time.monotonic() - t0

                is_straggler = False
                if len(window) >= 5:
                    med = max(float(np.median(window[-50:])),
                              self.straggler_floor_s)
                    if dt > self.straggler_factor * med:
                        is_straggler = True
                        stragglers += 1
                        if self.on_straggler:
                            self.on_straggler(step, dt / med)
                if is_straggler:
                    consec_outliers += 1
                if not is_straggler or consec_outliers > 3:
                    window.append(dt)
                if not is_straggler:
                    consec_outliers = 0
                times.append(dt)

                rec.update(step=step, wall_s=dt, stragglers=stragglers)
                if log_f:
                    log_f.write(json.dumps(rec) + "\n")
                    log_f.flush()

                if shardings is not None:    # rank 0's notice decides
                    flag = [preempted["flag"]]
                    dist.broadcast_object_list(flag, src=0)
                    preempted["flag"] = flag[0]
                must_save = (self.ckpt_dir and
                             ((step + 1) % self.ckpt_every == 0
                              or preempted["flag"]
                              or step + 1 == num_steps))
                if must_save:
                    tree = (params, opt_state)
                    if shardings is not None:
                        tree = shardings.dtensors(tree)
                    save_checkpoint(self.ckpt_dir, step, tree,
                                    extras={"step": step},
                                    keep_n=self.keep_n)
                if preempted["flag"]:
                    break
                step += 1
        finally:
            signal.signal(signal.SIGTERM, prev_handler)
            if log_f:
                log_f.close()

        p50 = float(np.median(times)) if times else 0.0
        p99 = float(np.percentile(times, 99)) if times else 0.0
        return params, opt_state, {
            "final_step": step, "p50_s": p50, "p99_s": p99,
            "stragglers": stragglers, "preempted": preempted["flag"]}
