"""Fault-tolerant training runner: checkpoint/restart, deterministic data
replay, straggler mitigation hooks, failure injection for tests.

At 1000+ nodes the failure model is: (a) whole-job restarts (preemption,
hardware swap) -> periodic atomic checkpoints + resume-from-latest with
the data stream re-seeded by step id, (b) transient stragglers -> a
per-step deadline watchdog; on TPU pods a straggler manifests as a slow
all-reduce, and the mitigation (documented here, simulated in tests) is
to drop to the last checkpoint and re-mesh without the slow host
(`launch/elastic.py` does the re-mesh), (c) silent data corruption ->
loss-spike detector that rolls back to the previous checkpoint.

Port of ``repro.distributed.fault_tolerance``: the same runner over the
port's ``CheckpointManager``; ``train_step`` is any step of
``repro_torch.train.steps`` (its loss a tensor or a float). A sharded
state (``param_specs`` and ``mesh``: params and AdamW state are this
rank's blocks) is saved as global arrays and restored onto ``mesh``,
so a run resumes on another mesh; every rank of the mesh runs the
runner.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import P, opt_state_specs


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_steps: int = 200
    loss_spike_factor: float = 10.0   # rollback if loss > factor * median
    step_deadline_s: Optional[float] = None  # straggler watchdog


class TrainingRunner:
    """Drives (params, opt_state) through train_step with FT behaviors.

    ``batch_at(step)`` must be a pure function of step (deterministic
    replay); ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.
    """

    def __init__(self, cfg: RunnerConfig, train_step: Callable,
                 batch_at: Callable, inject_failure_at: Optional[int] = None,
                 *, param_specs=None, mesh=None):
        self.cfg = cfg
        self._specs = {} if param_specs is None else dict(
            spec_tree={"params": param_specs,
                       "opt_state": opt_state_specs(param_specs),
                       "step": P()}, mesh=mesh)
        self.train_step = train_step
        self.batch_at = batch_at
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.inject_failure_at = inject_failure_at
        self.loss_history: list = []
        self.events: list = []

    def _state_tree(self, params, opt_state, step):
        return {"params": params, "opt_state": opt_state,
                "step": np.asarray(step, np.int32)}

    def run(self, params, opt_state, start_step: int = 0):
        step = start_step
        # resume from latest checkpoint if one exists
        restored, manifest = self.ckpt.restore_latest(
            self._state_tree(params, opt_state, 0), **self._specs)
        if restored is not None:
            params = restored["params"]
            opt_state = restored["opt_state"]
            step = int(restored["step"])
            self.events.append(("resume", step))

        while step < self.cfg.max_steps:
            if self.inject_failure_at is not None \
                    and step == self.inject_failure_at:
                self.inject_failure_at = None
                self.events.append(("failure", step))
                # The injected failure kills the training loop, not the
                # checkpoint writer: flush any in-flight async save so a
                # restart sees every checkpoint issued before the failure.
                self.ckpt.wait()
                raise SimulatedFailure(step)

            t0 = time.perf_counter()
            batch = self.batch_at(step)
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0

            if self.cfg.step_deadline_s and dt > self.cfg.step_deadline_s:
                self.events.append(("straggler", step, dt))

            # silent-corruption guard: loss spike -> rollback
            if len(self.loss_history) >= 8:
                med = float(np.median(self.loss_history[-8:]))
                # `np.isfinite` returns np.bool_, which is never `is`
                # Python's False — the identity check silently skipped
                # NaN/inf losses.
                if not np.isfinite(loss) \
                        or loss > self.cfg.loss_spike_factor * max(med, 1e-9):
                    # an async save issued before the spike may still be
                    # in flight: land it, so the rollback target does
                    # not depend on the writer thread's timing
                    self.ckpt.wait()
                    prev = self.ckpt.latest_step()
                    if prev is not None:
                        restored, _ = self.ckpt.restore(
                            prev, self._state_tree(params, opt_state, 0),
                            **self._specs)
                        params = restored["params"]
                        opt_state = restored["opt_state"]
                        step = int(restored["step"])
                        self.events.append(("rollback", step))
                        self.loss_history.clear()
                        continue
            self.loss_history.append(loss)

            step += 1
            if step % self.cfg.ckpt_every == 0 or step == self.cfg.max_steps:
                self.ckpt.save(step, self._state_tree(params, opt_state,
                                                      step), **self._specs)
        self.ckpt.wait()
        return params, opt_state, step


class SimulatedFailure(RuntimeError):
    def __init__(self, step):
        super().__init__(f"simulated node failure at step {step}")
        self.step = step
