"""What both kinds of cell share."""

from __future__ import annotations

import gc
import importlib
import time
from dataclasses import dataclass, field, fields

import torch

from portbench import traffic as T
from portbench import weights


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file's numbers (the
    keys it does not know, such as ``family`` and ``parameters``, left
    out)."""
    from repro_torch.configs.base import ModelConfig

    names = {f.name for f in fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


@dataclass
class Cell:
    """One run of one cell."""

    workload: str
    cfg: dict  # the configuration file's numbers
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float  # host clock at the process's start

    def model_config(self):
        return model_config(self.cfg)

    def family(self):
        return importlib.import_module(f"portbench.families.{self.cfg['family']}")

    def reference(self):
        return importlib.import_module(f"portbench.reference.{self.cfg['family']}")

    def weights(self, dtype_of) -> dict:
        gen = T.generator(self.seed, "weights", self.device)
        return weights.make(self.family().layout(self.cfg), gen, dtype_of, self.device)


@dataclass
class Outcome:
    metrics: dict  # end-to-end metrics of an untraced run
    attempted: int
    failed: int
    numbers: dict  # what the check compares
    memory_peak_bytes: int
    trace: object = None  # portbench.trace.Trace of a traced run
    work: dict = None  # the model's work in the traced window, by kernel class
    notes: dict = field(default_factory=dict)  # printed on an earlier line


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device: str) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def release(device: str) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Clock:
    """Seconds of set-up, less what the check spends inside it."""

    def __init__(self, started: float):
        self.started = started
        self.excluded = 0.0

    def exclude(self, t0: float) -> None:
        self.excluded += time.perf_counter() - t0

    def setup_s(self) -> float:
        return time.perf_counter() - self.started - self.excluded
