"""Workload descriptions for the NUMA simulator (port of
``repro.core.numa.workload``).

A :class:`Workload` carries *per-thread* ground-truth access mixes as
float32 tensors on one device.  Homogeneous workloads share one mix
across threads (the paper's 4-class model is exact); the Page-rank
violator gives its hot threads a different mix and intensity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device


class Workload(NamedTuple):
    """Ground truth for ``n`` threads: ``(n,)`` float32 fraction arrays
    per direction (interleaved = remainder), ``*_bpi`` bytes/instruction,
    and the int32 scalar ``static_socket`` naming the node holding the
    Static allocation."""

    name: str
    read_static: torch.Tensor
    read_local: torch.Tensor
    read_per_thread: torch.Tensor
    write_static: torch.Tensor
    write_local: torch.Tensor
    write_per_thread: torch.Tensor
    read_bpi: torch.Tensor
    write_bpi: torch.Tensor
    static_socket: torch.Tensor  # int32 scalar

    @property
    def n_threads(self) -> int:
        """Thread count (the leading axis of every per-thread field)."""
        return self.read_static.shape[0]

    @property
    def device(self) -> torch.device:
        """The device every field lives on."""
        return self.read_static.device

    def read_interleaved(self) -> torch.Tensor:
        """Per-thread interleaved read fraction — the residual class."""
        return 1.0 - self.read_static - self.read_local - self.read_per_thread

    def write_interleaved(self) -> torch.Tensor:
        """Per-thread interleaved write fraction — the residual class."""
        return 1.0 - self.write_static - self.write_local - self.write_per_thread


def mixed_workload(
    name: str,
    n_threads: int,
    *,
    read_mix: tuple[float, float, float] = (0.0, 0.0, 0.0),
    write_mix: tuple[float, float, float] | None = None,
    read_bpi: float = 0.6,
    write_bpi: float = 0.2,
    static_socket: int = 0,
    device=DEFAULT_DEVICE,
) -> Workload:
    """A homogeneous workload: every thread shares the same
    ``(static, local, per_thread)`` mix — the model-representable case."""
    if write_mix is None:
        write_mix = read_mix
    for mix in (read_mix, write_mix):
        if not (min(mix) >= 0.0 and sum(mix) <= 1.0 + 1e-6):
            raise ValueError(f"invalid traffic mix {mix}")
    dev = resolve_device(device)
    ones = torch.ones((n_threads,), dtype=torch.float32, device=dev)
    return Workload(
        name=name,
        read_static=ones * read_mix[0],
        read_local=ones * read_mix[1],
        read_per_thread=ones * read_mix[2],
        write_static=ones * write_mix[0],
        write_local=ones * write_mix[1],
        write_per_thread=ones * write_mix[2],
        read_bpi=ones * read_bpi,
        write_bpi=ones * write_bpi,
        static_socket=torch.tensor(static_socket, dtype=torch.int32, device=dev),
    )


def pure_workload(
    name: str,
    n_threads: int,
    pattern: str,
    *,
    read_bpi: float = 0.6,
    write_bpi: float = 0.2,
    static_socket: int = 0,
    device=DEFAULT_DEVICE,
) -> Workload:
    """The §6.1 synthetic benchmarks: a single pure pattern (Static /
    Local / Interleaved / Per-thread)."""
    mixes = {
        "static": (1.0, 0.0, 0.0),
        "local": (0.0, 1.0, 0.0),
        "per_thread": (0.0, 0.0, 1.0),
        "interleaved": (0.0, 0.0, 0.0),
    }
    if pattern not in mixes:
        raise ValueError(f"unknown pattern {pattern!r}")
    return mixed_workload(
        name,
        n_threads,
        read_mix=mixes[pattern],
        write_mix=mixes[pattern],
        read_bpi=read_bpi,
        write_bpi=write_bpi,
        static_socket=static_socket,
        device=device,
    )


def violator_workload(
    name: str,
    n_threads: int,
    *,
    base_read_mix: tuple[float, float, float] = (0.05, 0.15, 0.4),
    hot_fraction: float = 0.5,
    hot_intensity: float = 2.0,
    hot_extra_static: float = 0.35,
    read_bpi: float = 0.7,
    write_bpi: float = 0.15,
    static_socket: int = 0,
    device=DEFAULT_DEVICE,
) -> Workload:
    """A Page-rank-like model violator (paper §6.2, Figure 16): the first
    ``hot_fraction`` of the threads are hotter and lean harder on a
    shared early region that moves with them."""
    dev = resolve_device(device)
    n = n_threads
    t = torch.arange(n, device=dev)
    # round half to even, as jnp.round does
    hot = (t < torch.round(torch.tensor(hot_fraction * n, device=dev))).to(torch.float32)
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    rs, rl, rp = base_read_mix
    read_static = ones * rs + hot * hot_extra_static
    read_local = ones * rl * (1.0 - hot * 0.5)
    read_per_thread = ones * rp * (1.0 - hot * 0.5)
    # keep each thread's mix a valid distribution
    total = read_static + read_local + read_per_thread
    scale = torch.clamp(1.0 / torch.clamp(total, min=1e-9), max=1.0)
    read_static, read_local, read_per_thread = (
        read_static * scale,
        read_local * scale,
        read_per_thread * scale,
    )
    bpi = ones * read_bpi * (1.0 + hot * (hot_intensity - 1.0))
    return Workload(
        name=name,
        read_static=read_static,
        read_local=read_local,
        read_per_thread=read_per_thread,
        write_static=ones * 0.05,
        write_local=ones * 0.6,
        write_per_thread=ones * 0.2,
        read_bpi=bpi,
        write_bpi=ones * write_bpi,
        static_socket=torch.tensor(static_socket, dtype=torch.int32, device=dev),
    )
