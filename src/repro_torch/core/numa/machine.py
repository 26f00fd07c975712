"""Machine descriptions for the NUMA simulator (port of
``repro.core.numa.machine``).

A :class:`MachineSpec` is hashable python scalars plus a
:class:`~repro_torch.core.numa.topology.Topology`, field for field the
reference's spec, so :meth:`MachineSpec.fingerprint` returns the
reference's exact digest (it hashes ``repr()`` of every field, topology
included).  The tensor views (caps vectors, node rates) take the device
to build on; they are float32, as the reference's are with x64 off.

Paper §2 / Figure 2 bandwidth ratios parameterize the two evaluation
machines; the 4- and 8-socket, SNC, throttled and mixed-DIMM presets are
the reference's beyond-paper machines, copied value for value.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.numa.topology import Topology, fully_connected, glued_8s, snc

GB = 1e9


class MachineSpec(NamedTuple):
    """A multi-socket NUMA machine, modeled as a graph of NUMA nodes.

    Bandwidth capacities are bytes/s and **per node**.  ``remote_*_bw``
    cap each one-hop ordered node pair's path; longer routes are
    attenuated by ``hop_attenuation`` per extra hop.  ``core_rate`` and
    ``local_*_bw`` are one scalar for every node or a per-node tuple.
    """

    name: str
    sockets: int
    cores_per_socket: int
    local_read_bw: float | tuple[float, ...]
    local_write_bw: float | tuple[float, ...]
    remote_read_bw: float
    remote_write_bw: float
    core_rate: float | tuple[float, ...]
    topology: Topology
    hop_attenuation: float = 1.0
    nodes_per_socket: int = 1

    @property
    def total_cores(self) -> int:
        """Cores machine-wide — the hard cap on thread count."""
        return self.sockets * self.cores_per_socket

    @property
    def n_nodes(self) -> int:
        """NUMA nodes — the unit of placement, memory banks and counters."""
        return self.sockets * self.nodes_per_socket

    @property
    def cores_per_node(self) -> int:
        """Placement slots per NUMA node (SNC splits a socket's cores)."""
        return self.cores_per_socket // self.nodes_per_socket

    @property
    def n_links(self) -> int:
        """Physical interconnect links in the routed topology."""
        return self.topology.n_links

    def node_rates(self, device=DEFAULT_DEVICE) -> torch.Tensor:
        """``(n_nodes,)`` float32 per-node core issue rate (instructions/s)."""
        dev = resolve_device(device)
        if isinstance(self.core_rate, tuple):
            return torch.tensor(self.core_rate, dtype=torch.float32, device=dev)
        return torch.full((self.n_nodes,), self.core_rate, dtype=torch.float32, device=dev)

    def validate(self) -> None:
        """Raise ``ValueError`` on an inconsistent spec (SNC split that
        does not divide the cores, per-node tuples of the wrong length,
        topology/node-count mismatch)."""
        if self.nodes_per_socket < 1:
            raise ValueError("nodes_per_socket must be >= 1")
        if self.cores_per_socket % self.nodes_per_socket:
            raise ValueError(
                f"{self.cores_per_socket} cores/socket do not split evenly "
                f"over {self.nodes_per_socket} nodes/socket"
            )
        if self.topology.n_nodes != self.n_nodes:
            raise ValueError(
                f"topology has {self.topology.n_nodes} nodes; machine has "
                f"{self.sockets} sockets x {self.nodes_per_socket} nodes = "
                f"{self.n_nodes}"
            )
        if isinstance(self.core_rate, tuple):
            if len(self.core_rate) != self.n_nodes:
                raise ValueError(
                    f"core_rate has {len(self.core_rate)} entries for "
                    f"{self.n_nodes} nodes"
                )
            if min(self.core_rate) <= 0:
                raise ValueError("core_rate entries must be positive")
        elif self.core_rate <= 0:
            raise ValueError("core_rate must be positive")
        for field in ("local_read_bw", "local_write_bw"):
            bw = getattr(self, field)
            if isinstance(bw, tuple):
                if len(bw) != self.n_nodes:
                    raise ValueError(
                        f"{field} has {len(bw)} entries for {self.n_nodes} nodes"
                    )
                if min(bw) <= 0:
                    raise ValueError(f"{field} entries must be positive")
            elif bw <= 0:
                raise ValueError(f"{field} must be positive")

    def node_local_bw(self, direction: str, device=DEFAULT_DEVICE) -> torch.Tensor:
        """``(n_nodes,)`` float32 per-node local bank capacity for one
        direction; a scalar field broadcasts to every node."""
        if direction == "read":
            bw = self.local_read_bw
        elif direction == "write":
            bw = self.local_write_bw
        else:
            raise ValueError(f"unknown direction {direction!r}")
        dev = resolve_device(device)
        if isinstance(bw, tuple):
            return torch.tensor(bw, dtype=torch.float32, device=dev)
        return torch.full((self.n_nodes,), bw, dtype=torch.float32, device=dev)

    def bank_read_caps(self, device=DEFAULT_DEVICE) -> torch.Tensor:
        """``(n_nodes,)`` per-bank read capacity."""
        return self.node_local_bw("read", device)

    def bank_write_caps(self, device=DEFAULT_DEVICE) -> torch.Tensor:
        """``(n_nodes,)`` per-bank write capacity."""
        return self.node_local_bw("write", device)

    def link_caps(self, device=DEFAULT_DEVICE) -> torch.Tensor:
        """Per-link interconnect capacities, ``(n_links,)`` float32."""
        return torch.tensor(
            self.topology.link_bw, dtype=torch.float32, device=resolve_device(device)
        )

    def _remote_caps(self, base: float, device) -> torch.Tensor:
        dev = resolve_device(device)
        hops = torch.as_tensor(np.array(self.topology.hop_matrix(), np.float32), device=dev)
        att = torch.tensor(self.hop_attenuation, dtype=torch.float32, device=dev) ** (
            torch.clamp(hops - 1.0, min=0.0)
        )
        return torch.where(hops == 0, torch.inf, base * att)

    def remote_read_caps(self, device=DEFAULT_DEVICE) -> torch.Tensor:
        """``(n_nodes, n_nodes)`` per-ordered-node-pair remote read
        capacity: ``inf`` on the diagonal, the 1-hop cap attenuated per
        extra routed hop elsewhere."""
        return self._remote_caps(self.remote_read_bw, device)

    def remote_write_caps(self, device=DEFAULT_DEVICE) -> torch.Tensor:
        """``(n_nodes, n_nodes)`` remote write twin of
        :meth:`remote_read_caps`."""
        return self._remote_caps(self.remote_write_bw, device)

    def fingerprint(self) -> str:
        """Content digest over every field (topology included), equal to
        the reference spec's ``fingerprint()`` for the same fields."""
        return _fingerprint(self)


@lru_cache(maxsize=256)
def _fingerprint(machine: MachineSpec) -> str:
    digest = hashlib.blake2b(digest_size=16)
    for part in (
        machine.name,
        machine.sockets,
        machine.cores_per_socket,
        machine.nodes_per_socket,
        machine.local_read_bw,
        machine.local_write_bw,
        machine.remote_read_bw,
        machine.remote_write_bw,
        machine.core_rate,
        machine.hop_attenuation,
        machine.topology,
    ):
        digest.update(repr(part).encode())
        digest.update(b"\x1f")  # field separator: '325.0' != '32','5.0'
    return digest.hexdigest()


def canonical_bank_assignment(
    machine: MachineSpec, bank_assignment
) -> tuple[int, ...] | None:
    """Validate and canonicalize a page/bank placement:
    ``bank_assignment[k] = j`` backs the Local-class buffers of threads on
    node ``k`` with node ``j``'s DIMMs.  ``None`` and the identity both
    mean node-local and normalize to ``None``."""
    if bank_assignment is None:
        return None
    s = machine.n_nodes
    ba = tuple(int(b) for b in bank_assignment)
    if len(ba) != s:
        raise ValueError(
            f"bank_assignment {ba} has {len(ba)} entries for {s} nodes"
        )
    if any(not 0 <= b < s for b in ba):
        raise ValueError(f"bank_assignment {ba} names a node outside 0..{s - 1}")
    if ba == tuple(range(s)):
        return None  # identity == node-local default
    return ba


# Xeon E5-2630 v3: 8 cores, 2.4 GHz, DDR4-1866 (paper remote ratios 0.16/0.23).
E5_2630_V3 = MachineSpec(
    name="E5-2630v3-8c",
    sockets=2,
    cores_per_socket=8,
    local_read_bw=52.0 * GB,
    local_write_bw=28.0 * GB,
    remote_read_bw=0.16 * 52.0 * GB,
    remote_write_bw=0.23 * 28.0 * GB,
    core_rate=(2.4e9, 2.4e9),
    topology=fully_connected(2, 16.0 * GB),
)

# Xeon E5-2699 v3: 18 cores, 2.3 GHz, DDR4-2133 (paper remote ratios 0.59/0.83).
E5_2699_V3 = MachineSpec(
    name="E5-2699v3-18c",
    sockets=2,
    cores_per_socket=18,
    local_read_bw=62.0 * GB,
    local_write_bw=34.0 * GB,
    remote_read_bw=0.59 * 62.0 * GB,
    remote_write_bw=0.83 * 34.0 * GB,
    core_rate=(2.3e9, 2.3e9),
    topology=fully_connected(2, 51.2 * GB),
)

# Xeon E7-4830 v3: quad-socket Haswell-EX, fully connected QPI.
E7_4830_V3 = MachineSpec(
    name="E7-4830v3-4s12c",
    sockets=4,
    cores_per_socket=12,
    local_read_bw=46.0 * GB,
    local_write_bw=25.0 * GB,
    remote_read_bw=0.30 * 46.0 * GB,
    remote_write_bw=0.40 * 25.0 * GB,
    core_rate=(2.1e9,) * 4,
    topology=fully_connected(4, 19.2 * GB),
)

# Xeon E7-8860 v3: two fully QPI-meshed quads glued by node controllers.
E7_8860_V3 = MachineSpec(
    name="E7-8860v3-8s16c",
    sockets=8,
    cores_per_socket=16,
    local_read_bw=50.0 * GB,
    local_write_bw=27.0 * GB,
    remote_read_bw=0.35 * 50.0 * GB,
    remote_write_bw=0.45 * 27.0 * GB,
    core_rate=(2.2e9,) * 8,
    topology=glued_8s(qpi_bw=12.8 * GB, nc_bw=9.6 * GB),
    hop_attenuation=0.8,
)

# The 18-core machine in SNC-2 / Cluster-on-Die mode.
E5_2699_V3_SNC2 = MachineSpec(
    name="E5-2699v3-18c-snc2",
    sockets=2,
    cores_per_socket=18,
    nodes_per_socket=2,
    local_read_bw=31.0 * GB,
    local_write_bw=17.0 * GB,
    remote_read_bw=0.59 * 31.0 * GB,
    remote_write_bw=0.83 * 17.0 * GB,
    core_rate=(2.3e9,) * 4,
    topology=snc(2, 2, qpi_bw=51.2 * GB, intra_bw=44.0 * GB),
    hop_attenuation=0.9,
)

# The 8-core machine with socket 1 thermally throttled to 2/3 clock.
E5_2630_V3_THROTTLED = MachineSpec(
    name="E5-2630v3-8c-throttled",
    sockets=2,
    cores_per_socket=8,
    local_read_bw=52.0 * GB,
    local_write_bw=28.0 * GB,
    remote_read_bw=0.16 * 52.0 * GB,
    remote_write_bw=0.23 * 28.0 * GB,
    core_rate=(2.4e9, 1.6e9),
    topology=fully_connected(2, 16.0 * GB),
)

# The 8-core machine with socket 1's DIMM slots half-populated.
E5_2630_V3_MIXED_DIMM = MachineSpec(
    name="E5-2630v3-8c-mixed-dimm",
    sockets=2,
    cores_per_socket=8,
    local_read_bw=(52.0 * GB, 26.0 * GB),
    local_write_bw=(28.0 * GB, 14.0 * GB),
    remote_read_bw=0.16 * 52.0 * GB,
    remote_write_bw=0.23 * 28.0 * GB,
    core_rate=(2.4e9, 2.4e9),
    topology=fully_connected(2, 16.0 * GB),
)

MACHINES: dict[str, MachineSpec] = {
    E5_2630_V3.name: E5_2630_V3,
    E5_2699_V3.name: E5_2699_V3,
    E7_4830_V3.name: E7_4830_V3,
    E7_8860_V3.name: E7_8860_V3,
    E5_2699_V3_SNC2.name: E5_2699_V3_SNC2,
    E5_2630_V3_THROTTLED.name: E5_2630_V3_THROTTLED,
    E5_2630_V3_MIXED_DIMM.name: E5_2630_V3_MIXED_DIMM,
}

for _machine in MACHINES.values():
    _machine.validate()


def _as_node_bw(value) -> float | tuple[float, ...]:
    """Scalars stay scalars, sequences become hashable per-node tuples."""
    if isinstance(value, (int, float)):
        return float(value)
    return tuple(float(v) for v in value)


def make_machine(
    name: str = "generic",
    sockets: int = 2,
    cores_per_socket: int = 8,
    local_read_bw: float | tuple[float, ...] = 50.0 * GB,
    local_write_bw: float | tuple[float, ...] = 28.0 * GB,
    remote_read_ratio: float = 0.5,
    remote_write_ratio: float = 0.5,
    qpi_bw: float = 32.0 * GB,
    core_rate: float | tuple[float, ...] = 2.4e9,
    topology: Topology | None = None,
    hop_attenuation: float = 1.0,
    nodes_per_socket: int = 1,
    intra_bw: float | None = None,
) -> MachineSpec:
    """Build a custom machine from local bandwidths and remote/local
    ratios.  Without an explicit ``topology`` every node pair gets a
    direct ``qpi_bw`` link (``nodes_per_socket == 1``) or an SNC topology
    with ``intra_bw`` intra-socket links (default ``2 * qpi_bw``)."""
    n_nodes = sockets * nodes_per_socket
    if topology is None:
        if nodes_per_socket == 1:
            topology = fully_connected(sockets, qpi_bw)
        else:
            topology = snc(
                sockets,
                nodes_per_socket,
                qpi_bw=qpi_bw,
                intra_bw=2.0 * qpi_bw if intra_bw is None else intra_bw,
            )
    if not isinstance(core_rate, (int, float)):
        core_rate = tuple(float(r) for r in core_rate)
        if len(core_rate) == 1:
            core_rate = core_rate * n_nodes
    local_read_bw = _as_node_bw(local_read_bw)
    local_write_bw = _as_node_bw(local_write_bw)
    # with per-node local tuples the scalar remote caps anchor on the mean
    mean_read = (
        sum(local_read_bw) / len(local_read_bw)
        if isinstance(local_read_bw, tuple)
        else local_read_bw
    )
    mean_write = (
        sum(local_write_bw) / len(local_write_bw)
        if isinstance(local_write_bw, tuple)
        else local_write_bw
    )
    machine = MachineSpec(
        name=name,
        sockets=sockets,
        cores_per_socket=cores_per_socket,
        local_read_bw=local_read_bw,
        local_write_bw=local_write_bw,
        remote_read_bw=remote_read_ratio * mean_read,
        remote_write_bw=remote_write_ratio * mean_write,
        core_rate=core_rate,
        topology=topology,
        hop_attenuation=hop_attenuation,
        nodes_per_socket=nodes_per_socket,
    )
    machine.validate()
    return machine
