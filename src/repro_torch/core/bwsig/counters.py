"""Performance-counter samples — the data the model is fitted from (port
of ``repro.core.bwsig.counters``).

Paper §2.1: per memory bank, the volume of data moved for the *local*
socket and for *remote* sockets (bank perspective), plus per-socket
instruction counts and the elapsed time.  Every field may carry leading
batch dimensions (the reference's ``vmap`` axes, written out); the bank
axis is always last.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CounterSample(NamedTuple):
    """One profiling run's counter readings on an ``s``-bank machine.

    Per-bank arrays have shape ``(..., s)``; ``instructions`` is per node;
    ``elapsed`` is seconds (a scalar or one per leading batch entry);
    ``n_per_socket`` is the run's placement.
    """

    local_read: torch.Tensor
    remote_read: torch.Tensor
    local_write: torch.Tensor
    remote_write: torch.Tensor
    instructions: torch.Tensor
    elapsed: torch.Tensor
    n_per_socket: torch.Tensor

    @property
    def sockets(self) -> int:
        """The number of banks ``s``."""
        return self.local_read.shape[-1]

    def totals(self, direction: str) -> torch.Tensor:
        """Total per-bank traffic of ``direction`` (``"read"``,
        ``"write"`` or ``"combined"``; paper §5.3)."""
        if direction == "read":
            return self.local_read + self.remote_read
        if direction == "write":
            return self.local_write + self.remote_write
        if direction == "combined":
            return self.local_read + self.remote_read + self.local_write + self.remote_write
        raise ValueError(f"unknown direction {direction!r}")

    def combined(self) -> "CounterSample":
        """Collapse reads and writes into the read slots (paper §6.2.1's
        combined-bandwidth signature); the write slots become zeros."""
        return CounterSample(
            local_read=self.local_read + self.local_write,
            remote_read=self.remote_read + self.remote_write,
            local_write=torch.zeros_like(self.local_write),
            remote_write=torch.zeros_like(self.remote_write),
            instructions=self.instructions,
            elapsed=self.elapsed,
            n_per_socket=self.n_per_socket,
        )


def counters_from_flows(
    read_flows: torch.Tensor,
    write_flows: torch.Tensor,
    instructions: torch.Tensor,
    elapsed,
    n_per_socket,
) -> CounterSample:
    """Reduce ground-truth ``flows[..., i, j]`` (node ``i`` CPUs -> bank
    ``j``, bytes) to the bank-perspective counters of paper §2.1."""
    dev = read_flows.device
    l_read = torch.diagonal(read_flows, dim1=-2, dim2=-1)
    r_read = read_flows.sum(dim=-2) - l_read
    l_write = torch.diagonal(write_flows, dim1=-2, dim2=-1)
    r_write = write_flows.sum(dim=-2) - l_write
    return CounterSample(
        local_read=l_read,
        remote_read=r_read,
        local_write=l_write,
        remote_write=r_write,
        instructions=instructions,
        elapsed=torch.as_tensor(elapsed, dtype=torch.float32, device=dev),
        n_per_socket=torch.as_tensor(n_per_socket, device=dev),
    )
