"""Fault-tolerant training runtime (port of
``repro.runtime.fault_tolerance``).

* :class:`TrainLoop` — checkpoint/restart orchestration: periodic async
  saves, automatic resume from the latest valid manifest, deterministic
  data replay (the port's ``TokenStream`` is seeded per step, so a restart
  replays the exact failed step).
* :class:`StragglerMonitor` — EWMA step-time outlier detection with a
  pluggable reaction hook.
* :class:`FailureInjector` — deterministic fault injection for tests
  (fail at step k, resume, verify a bit-identical continuation).

The reference's ``remesh`` (elastic re-sharding onto another mesh) needs
several devices and waits for ROADMAP §1 P14 (multi-card).

The port's training state is updated in place (the train step writes the
new parameters and moments into the same tensors), so two things differ
from the reference: a restart restores the checkpoint into the live
state's own tensors (``store.restore_into``, where the reference builds a
new tree from ``jax.eval_shape``), and a step that raises first waits for
the checkpoint in flight, so the restart finds it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import torch

from repro_torch.checkpoint import store


class StragglerMonitor:
    """Flags steps whose wall time exceeds ``threshold`` x the EWMA;
    outliers do not move the average."""

    def __init__(self, alpha: float = 0.2, threshold: float = 2.0,
                 on_straggler: Callable[[int, float, float], None] | None = None):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: float | None = None
        self.flagged: list[tuple[int, float, float]] = []
        self.on_straggler = on_straggler

    def observe(self, step: int, seconds: float) -> bool:
        if self.ewma is not None and seconds > self.threshold * self.ewma:
            self.flagged.append((step, seconds, self.ewma))
            if self.on_straggler:
                self.on_straggler(step, seconds, self.ewma)
            return True
        self.ewma = (
            seconds if self.ewma is None else (1 - self.alpha) * self.ewma + self.alpha * seconds
        )
        return False


class FailureInjector:
    """Raises a simulated node failure at the configured steps, once each."""

    class NodeFailure(RuntimeError):
        pass

    def __init__(self, fail_at: set[int] | None = None):
        self.fail_at = set(fail_at or ())
        self.fired: set[int] = set()

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise self.NodeFailure(f"injected node failure at step {step}")


def _sync(state: Any) -> None:
    """Wait for the device of the state's first tensor (the reference's
    ``jax.block_until_ready``)."""
    for _, leaf in store._items(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


@dataclass
class TrainLoop:
    """Checkpoint/restart training driver.

    ``state`` is a tree of tensors (parameters, optimizer state) that
    ``step_fn(state, step) -> (state, metrics)`` advances by one training
    step."""

    step_fn: Callable[[Any, int], tuple[Any, dict]]
    ckpt_dir: str | Path
    save_every: int = 50
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    injector: FailureInjector | None = None

    def resume_step(self) -> int | None:
        return store.latest_step(self.ckpt_dir)

    def run(self, state: Any, n_steps: int, *, start_step: int | None = None
            ) -> tuple[Any, int, list[dict]]:
        """Run up to ``n_steps`` total; resumes from the latest checkpoint
        (restored into ``state``) when ``start_step`` is None.  Returns
        ``(state, step, metrics)``."""
        ckpt = store.AsyncCheckpointer(self.ckpt_dir)
        step = start_step
        if step is None:
            latest = self.resume_step()
            if latest is not None:
                state = store.restore_into(self.ckpt_dir, latest, state)
                step = latest
            else:
                step = 0
        history: list[dict] = []
        try:
            while step < n_steps:
                if self.injector is not None:
                    self.injector.check(step)
                t0 = time.time()
                state, metrics = self.step_fn(state, step)
                _sync(state)
                dt = time.time() - t0
                self.monitor.observe(step, dt)
                history.append({"step": step, "seconds": dt, **metrics})
                step += 1
                if step % self.save_every == 0 or step == n_steps:
                    ckpt.save(step, state)
        finally:
            ckpt.wait()
        return state, step, history
