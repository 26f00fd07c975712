"""State carried across from the JAX reference into the port.

The reference's objects are handed over as plain Python and numpy values
(``MachineSpec._asdict()``, workload arrays, signature leaves), so this
module imports no JAX.  Every numpy array becomes a tensor of the
reference's dtype with x64 off: float32 for values, int32 for indices.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.bwsig.signature import BandwidthSignature, DirectionSignature
from repro_torch.core.numa.machine import MachineSpec
from repro_torch.core.numa.topology import Topology

_WORKLOAD_FIELDS = (
    "read_static", "read_local", "read_per_thread",
    "write_static", "write_local", "write_per_thread",
    "read_bpi", "write_bpi",
)


def topology_from_fields(fields) -> Topology:
    """A :class:`Topology` from a reference topology's ``_asdict()`` (or
    the topology itself, which is a namedtuple of plain tuples)."""
    if not isinstance(fields, Mapping):
        fields = fields._asdict()
    return Topology(
        name=fields["name"],
        n_nodes=int(fields["n_nodes"]),
        link_ends=tuple(tuple(int(v) for v in e) for e in fields["link_ends"]),
        link_bw=tuple(float(v) for v in fields["link_bw"]),
        routes=tuple(tuple(int(v) for v in route) for route in fields["routes"]),
    )


def machine_from_fields(fields: Mapping) -> MachineSpec:
    """A :class:`MachineSpec` from ``MachineSpec._asdict()``; the
    ``topology`` entry may be the reference topology or its fields.  The
    result's ``fingerprint()`` equals the reference's."""
    fields = dict(fields)
    fields["topology"] = topology_from_fields(fields["topology"])
    machine = MachineSpec(**fields)
    machine.validate()
    return machine


def workload_from_arrays(
    name: str, arrays: Mapping[str, np.ndarray], *, device=DEFAULT_DEVICE
):
    """A port :class:`~repro_torch.core.numa.workload.Workload` from the
    reference workload's fields as numpy arrays (keyed by field name)."""
    from repro_torch.core.numa.workload import Workload

    dev = resolve_device(device)
    values = {
        f: torch.as_tensor(np.array(arrays[f], np.float32), device=dev)
        for f in _WORKLOAD_FIELDS
    }
    static_socket = torch.as_tensor(
        np.array(arrays["static_socket"], np.int32), device=dev
    )
    return Workload(name=name, static_socket=static_socket, **values)


def direction_from_arrays(
    static_socket, static_fraction, local_fraction, per_thread_fraction,
    *, device=DEFAULT_DEVICE,
) -> DirectionSignature:
    """One direction signature from the reference's four leaves."""
    dev = resolve_device(device)

    def f32(v):
        return torch.as_tensor(np.array(v, np.float32), device=dev)

    return DirectionSignature(
        static_socket=torch.as_tensor(np.array(static_socket, np.int32), device=dev),
        static_fraction=f32(static_fraction),
        local_fraction=f32(local_fraction),
        per_thread_fraction=f32(per_thread_fraction),
    )


def signature_from_arrays(read, write, *, device=DEFAULT_DEVICE) -> BandwidthSignature:
    """A :class:`BandwidthSignature` from the reference's leaves: ``read``
    and ``write`` are each the four direction leaves (``static_socket``,
    ``static_fraction``, ``local_fraction``, ``per_thread_fraction``) as a
    sequence or numpy values, e.g. ``tuple(np.asarray(v) for v in
    sig.read)``."""
    return BandwidthSignature(
        read=direction_from_arrays(*read, device=device),
        write=direction_from_arrays(*write, device=device),
    )
