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
* :func:`remesh` — elastic scaling: a whole state cut to another mesh's
  shards.  The port's checkpoints carry no mesh (every leaf whole), so a
  state saved by 8 ranks resumes on 4.

Under a mesh (``TrainLoop.cfg`` names the model whose leaves the state
holds) the loop gathers the shards on the calling thread before a save,
leaf by leaf into rank 0's host memory; rank 0 alone writes (its writer
thread runs no collective).  A resume waits for every rank at a barrier,
then loads the checkpoint one whole leaf at a time on the host and cuts
this rank's shard of it into the live tensor.

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
import torch.distributed as dist

from repro_torch.checkpoint import store
from repro_torch.launch import mesh as mesh_lib
from repro_torch.parallel import context as ctx


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
    step.  Under an active mesh ``state`` holds this rank's shards of
    ``cfg``'s leaves (``launch.mesh.shard_state``'s layout), and ``cfg``
    is required."""

    step_fn: Callable[[Any, int], tuple[Any, dict]]
    ckpt_dir: str | Path
    save_every: int = 50
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    injector: FailureInjector | None = None
    cfg: Any = None

    def resume_step(self) -> int | None:
        return store.latest_step(self.ckpt_dir)

    def _restore(self, step: int, state: Any, mesh) -> Any:
        """The checkpoint of ``step`` restored into ``state``'s tensors,
        leaf by leaf through host memory: whole, or under a mesh each
        whole leaf cut on the host to this rank's shard (:func:`remesh`)
        before it is copied to the device."""
        if mesh is None:
            return store.restore_into(self.ckpt_dir, step, state)
        names = dict(store._items(mesh_lib.leaf_names(state)))

        def cut(key: str, whole: torch.Tensor) -> torch.Tensor:
            name = names[key]
            return remesh({name: whole}, self.cfg, mesh)[name] if isinstance(name, str) else whole

        return store.restore_into(self.ckpt_dir, step, state, cut)

    def run(self, state: Any, n_steps: int, *, start_step: int | None = None
            ) -> tuple[Any, int, list[dict]]:
        """Run up to ``n_steps`` total; resumes from the latest checkpoint
        (restored into ``state``) when ``start_step`` is None.  Returns
        ``(state, step, metrics)``."""
        mesh = ctx.current_mesh()
        if mesh is not None and self.cfg is None:
            raise ValueError("a TrainLoop under a mesh needs cfg to gather and cut its state")
        ckpt = store.AsyncCheckpointer(self.ckpt_dir)
        step = start_step
        if step is None:
            if mesh is not None and mesh.size > 1:
                dist.barrier()  # rank 0's last checkpoint is committed
            latest = self.resume_step()
            if latest is not None:
                state = self._restore(latest, state, mesh)
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
                    if mesh is None:
                        ckpt.save(step, state)
                    else:  # every rank gathers; rank 0 keeps the leaves on its host
                        whole = mesh_lib.gather_state(self.cfg, state, root=0)
                        if whole is not None:
                            ckpt.save(step, whole, copy=False)
        finally:
            ckpt.wait()
        return state, step, history


def remesh(state: Any, cfg, new_mesh) -> Any:
    """Elastic re-shard: the whole ``state`` (every leaf whole, as a
    checkpoint holds it or ``launch.mesh.gather_state`` returns it) cut to
    this rank's shards of ``new_mesh`` under the active logical rules.
    The cuts are mesh-relative, so any rank count whose axes divide the
    leaves takes it."""
    with ctx.use_mesh(new_mesh):
        return mesh_lib.shard_state(cfg, state)
