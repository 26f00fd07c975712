"""The bandwidth signature and its application to thread placements
(port of ``repro.core.bwsig.signature``; paper §3 and §4).

``s`` is the number of sockets (NUMA nodes); placements are integer
vectors ``n_per_socket`` of shape ``(s,)``.  Matrices are indexed
``[cpu_socket, memory_bank]``.  Signature leaves may carry leading batch
dimensions; a placement then carries the same leading dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch



class DirectionSignature(NamedTuple):
    """Signature for one traffic direction — paper §3.  The Interleaved
    class is the remainder ``1 - (static + local + per_thread)``."""

    static_socket: torch.Tensor  # int32
    static_fraction: torch.Tensor  # float32 in [0, 1]
    local_fraction: torch.Tensor
    per_thread_fraction: torch.Tensor


class BandwidthSignature(NamedTuple):
    """The full 8-property signature: separate read and write directions."""

    read: DirectionSignature
    write: DirectionSignature


def interleaved_fraction(sig: DirectionSignature) -> torch.Tensor:
    """The remainder class — paper §3."""
    return torch.clamp(
        1.0 - sig.static_fraction - sig.local_fraction - sig.per_thread_fraction,
        0.0,
        1.0,
    )


def _static_matrix(static_socket: torch.Tensor, s: int) -> torch.Tensor:
    """All traffic lands on the static bank: one-hot column (paper §4)."""
    cols = torch.arange(s, device=static_socket.device)
    row = (cols == static_socket[..., None]).to(torch.float32)  # (..., s)
    return row[..., None, :].expand(*row.shape[:-1], s, s)


def _per_thread_matrix(n_per_socket: torch.Tensor) -> torch.Tensor:
    """Columns weighted by the fraction of threads on each socket."""
    n = n_per_socket.to(torch.float32)
    total = torch.clamp(n.sum(dim=-1, keepdim=True), min=1.0)
    weights = n / total
    s = n_per_socket.shape[-1]
    return weights[..., None, :].expand(*weights.shape[:-1], s, s)


def _interleaved_matrix(n_per_socket: torch.Tensor) -> torch.Tensor:
    """Traffic spread evenly over the *used* sockets (paper §4)."""
    used = (n_per_socket > 0).to(torch.float32)
    s_used = torch.clamp(used.sum(dim=-1), min=1.0)
    return (used[..., :, None] * used[..., None, :]) / s_used[..., None, None]


def placement_matrix(
    sig: DirectionSignature, n_per_socket: torch.Tensor
) -> torch.Tensor:
    """The ``(s, s)`` row-stochastic matrix of paper Figure 5: the four
    class matrices weighted by the signature fractions."""
    n_per_socket = torch.as_tensor(n_per_socket, device=sig.static_fraction.device)
    s = n_per_socket.shape[-1]
    inter = interleaved_fraction(sig)
    eye = torch.eye(s, dtype=torch.float32, device=n_per_socket.device)
    return (
        sig.static_fraction[..., None, None] * _static_matrix(sig.static_socket, s)
        + sig.local_fraction[..., None, None] * eye
        + sig.per_thread_fraction[..., None, None] * _per_thread_matrix(n_per_socket)
        + inter[..., None, None] * _interleaved_matrix(n_per_socket)
    )


def predict_flows(
    sig: DirectionSignature,
    demand_per_socket: torch.Tensor,
    n_per_socket: torch.Tensor,
) -> torch.Tensor:
    """``flows[i, j]`` = bytes/s from the CPUs on socket ``i`` to bank
    ``j``: the placement matrix rows scaled by per-socket demand."""
    m = placement_matrix(sig, n_per_socket)
    return demand_per_socket[..., :, None] * m


def predict_counters(
    sig: DirectionSignature,
    demand_per_socket: torch.Tensor,
    n_per_socket: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Predicted bank-perspective counters (paper §2.1): per-bank
    ``local`` and ``remote`` traffic."""
    flows = predict_flows(sig, demand_per_socket, n_per_socket)
    local = torch.diagonal(flows, dim1=-2, dim2=-1)
    remote = flows.sum(dim=-2) - local
    return local, remote
