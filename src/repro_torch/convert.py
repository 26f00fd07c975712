"""State carried across from the JAX reference into the port.

The reference's objects are handed over as plain Python and numpy values
(``MachineSpec._asdict()``, workload arrays, signature leaves, an LM's
parameter tree, calibration samples and parameters), so this module
imports no JAX.  Every numpy array becomes a tensor of the
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


def lm_params_from_reference(cfg, tree: Mapping, *, device=DEFAULT_DEVICE):
    """The port's :class:`~repro_torch.models.model.LM` holding the
    reference's parameter tree (``init_params``' nested dicts, leaves as
    numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) value for
    value and dtype for dtype.  The reference stacks each slot's leaves
    over groups; layer ``g * group_size + s`` gets group ``g`` of
    ``groups["slot<s>"]``, encoder layer ``i`` entry ``i`` of
    ``encoder.groups.slot0``.  MoE experts may be stored whole (the
    reference's ``factor`` 1, as with no mesh) or split over ``d_ff`` into
    ``factor`` rows each (a tree initialised under a mesh whose expert
    axis outnumbers the experts); rows that are no multiple of the experts
    raise ``ValueError``.  A split tree runs only under a mesh of its
    ``factor`` (:func:`lm_shards_from_reference`)."""
    from repro_torch.models.attention import Attention
    from repro_torch.models.layers import SwiGLU
    from repro_torch.models.mamba import Mamba
    from repro_torch.models.model import LM, Block, Encoder, Frontend, slot_kinds
    from repro_torch.models.moe import MoE

    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    def leaves(group: Mapping, names, g):
        return (t(group[n][g]) for n in names)

    def block(slot: Mapping, s: int, g: int) -> Block:
        mixer_kind, _, ffn_kind = slot_kinds(cfg, s)
        if mixer_kind == "attn":
            mixer = Attention(*leaves(slot["mixer"], ("wq", "wk", "wv", "wo"), g))
        else:
            mixer = Mamba(*leaves(slot["mixer"], Mamba.LEAVES, g))
        norm2 = ffn = None
        if ffn_kind == "moe":
            rows = slot["ffn"]["w_gate"].shape[1]
            if rows % cfg.n_experts:
                raise ValueError(
                    f"{cfg.name}: the tree holds {rows} expert rows for {cfg.n_experts} experts"
                )
            ffn = MoE(*leaves(slot["ffn"], MoE.LEAVES, g))
        elif ffn_kind == "dense":
            ffn = SwiGLU(*leaves(slot["ffn"], ("w_gate", "w_up", "w_down"), g))
        if ffn is not None:
            norm2 = t(slot["norm2"][g])
        if "cross" not in slot:
            return Block(t(slot["norm1"][g]), mixer, norm2, ffn)
        cross = Attention(*leaves(slot["cross"], ("wq", "wk", "wv", "wo"), g))
        return Block(t(slot["norm1"][g]), mixer, norm2, ffn, t(slot["norm_cross"][g]), cross)

    layers = [block(tree["groups"][f"slot{s}"], s, g)
              for g in range(cfg.n_groups) for s in range(cfg.group_size)]
    lm_head = None if cfg.tie_embeddings else t(tree["lm_head"])
    extra = {}
    if "frontend" in tree:
        extra["frontend"] = Frontend(t(tree["frontend"]["proj"]))
    if "encoder" in tree:
        enc = tree["encoder"]
        extra["encoder"] = Encoder(
            [block(enc["groups"]["slot0"], 0, i) for i in range(cfg.encoder_layers)],
            t(enc["final_norm"]),
        )
        extra["dec_pos"] = t(tree["dec_pos"])
    return LM(t(tree["embed"]["table"]), layers, t(tree["final_norm"]), lm_head, **extra)


def lm_shards_from_reference(cfg, tree: Mapping, *, device=DEFAULT_DEVICE):
    """This rank's shards (``launch.mesh.shard_params``) of the reference
    tree under the active mesh and logical rules (under a decode cell of
    weights not replicated, the 2-D decode cut of
    ``launch.mesh.serve_decode_param_rules``): the whole
    :class:`~repro_torch.models.model.LM` with no mesh."""
    from repro_torch.launch.mesh import shard_params

    return shard_params(cfg, lm_params_from_reference(cfg, tree, device=device))


def lm_params_to_reference(cfg, lm) -> dict:
    """The inverse of :func:`lm_params_from_reference`: the reference's
    nested parameter tree of numpy arrays, each slot's leaves stacked over
    groups (``groups["slot<s>"]``, leading axis ``g``; an encoder's over
    its layers, ``encoder.groups.slot0``), from the port's
    :class:`~repro_torch.models.model.LM` or from a mapping of its
    parameter names to tensors (e.g. each leaf's ``.grad``).  Leaves keep
    their dtype, except bfloat16, which numpy lacks: it comes back as
    float32 (exact).  Under a mesh an LM of this rank's shards is gathered
    first (``launch.mesh.gather_params``; every rank takes part)."""
    if hasattr(lm, "named_parameters"):
        from repro_torch.launch.mesh import gather_params

        lm = gather_params(cfg, lm)
    named = dict(lm.named_parameters()) if hasattr(lm, "named_parameters") else dict(lm)

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    tree: dict = {}
    stacks: dict[tuple, list] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            i = int(parts[1])
            key = ("groups", f"slot{i % cfg.group_size}", *parts[2:])
            stacks.setdefault(key, [None] * cfg.n_groups)[i // cfg.group_size] = host(t)
        elif parts[:2] == ["encoder", "layers"]:
            key = ("encoder", "groups", "slot0", *parts[3:])
            stacks.setdefault(key, [None] * cfg.encoder_layers)[int(parts[2])] = host(t)
        else:
            key = tuple(parts)
            node = tree
            for k in key[:-1]:
                node = node.setdefault(k, {})
            node[key[-1]] = host(t)
    for key, per_group in stacks.items():
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = np.stack(per_group)
    return tree


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


def calibration_samples_from_arrays(fields: Mapping, *, device=DEFAULT_DEVICE):
    """The port's :class:`~repro_torch.core.numa.calibrate.CalibrationSamples`
    from the reference's as numpy values (``samples._asdict()`` with every
    leaf through ``np.asarray``; ``wl_arrays`` a sequence whose last leaf
    is the int32 static socket).  Counters and workload fields float32,
    placements int32."""
    from repro_torch.core.numa.calibrate import CalibrationSamples

    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype), device=dev)

    *floats, static_socket = fields["wl_arrays"]
    return CalibrationSamples(
        wl_arrays=tuple(t(a, np.float32) for a in floats) + (t(static_socket, np.int32),),
        placements=t(fields["placements"], np.int32),
        **{f: t(fields[f], np.float32) for f in (
            "local_read", "remote_read", "local_write", "remote_write",
            "instructions", "elapsed",
        )},
    )


def calibration_params_from_arrays(fields: Mapping, *, device=DEFAULT_DEVICE):
    """The port's :class:`~repro_torch.core.numa.calibrate.CalibrationParams`
    from the reference's ``params._asdict()`` as numpy values (float32)."""
    from repro_torch.core.numa.calibrate import CalibrationParams

    dev = resolve_device(device)
    return CalibrationParams(**{
        f: torch.as_tensor(np.array(fields[f], np.float32), device=dev)
        for f in CalibrationParams._fields
    })
