"""Fitting a mesh bandwidth signature from two profiling runs (port of
``repro.core.meshsig.fit``; plain Python floats, as in the reference).

The paper's §5 protocol, transplanted to device meshes:

====================  =====================================================
paper                 mesh domain
====================  =====================================================
symmetric run         profile at mesh (16, 16): axis sizes equal, so a
                      group-of-16 collective cannot be attributed to an
                      axis (the Interleaved/Per-thread ambiguity of §5.1)
asymmetric run        profile at mesh (32, 8): group sizes now identify
                      the axis, the way unequal thread counts identify the
                      per-thread fraction in §5.5
Static class          all-gather traffic (same bytes pulled by every
                      member: FSDP weight gathers, replications)
Local class           bytes that never cross links (HBM minus collectives)
Interleaved class     all-reduce / reduce-scatter (ring-spread reduction)
Per-thread class      all-to-all + collective-permute (traffic follows
                      shard ownership: MoE dispatch, resharding)
====================  =====================================================

Each (class, axis) term carries two fit parameters: base bytes ``beta`` and
a batch-scaling exponent ``e in {0, 1}`` (weights-like traffic is
mesh-size-invariant per device; activations-like traffic scales inversely
with the number of batch shards).  Two runs give two equations per term,
exactly identifying both.

Prediction then gives per-axis link bytes for any mesh aspect without
profiling it.  The runs' counters arrive as a
:class:`~repro_torch.core.meshsig.counters.ProgramCounters` record.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.meshsig.counters import ProgramCounters

CLASS_OF_KIND = {
    "all-gather": "static",
    "all-reduce": "interleaved",
    "reduce-scatter": "interleaved",
    "all-to-all": "per_shard",
    "collective-permute": "per_shard",
}


def class_factor(cls: str, k: int) -> float:
    """Link-byte factor of one ring pass at axis size ``k`` for a class."""
    if k <= 1:
        return 0.0
    if cls == "interleaved":
        return 2.0 * (k - 1) / k
    return (k - 1) / k  # static (AG), per_shard (A2A); permute ~ 1 ~ (k-1)/k


@dataclass
class MeshProfile:
    """One profiling run's counters (the paper's CounterSample)."""

    axis_sizes: dict[str, int]  # e.g. {"data": 16, "model": 16}
    class_axis_bytes: dict[tuple[str, str], float]  # (class, axis) -> link bytes
    local_bytes: float  # HBM bytes that never cross links
    flops: float


def profile_from_analysis(
    analysis: ProgramCounters, axis_sizes: dict[str, int]
) -> MeshProfile:
    """Attribute collectives to axes by group size.  Requires distinct axis
    sizes for exact attribution (the asymmetric run); ties are split evenly
    (the symmetric run's inherent ambiguity, resolved by the fit)."""
    sizes = dict(axis_sizes)
    total_devices = math.prod(sizes.values())
    out: dict[tuple[str, str], float] = {}
    coll_bytes = 0.0
    for op in analysis.collectives:
        cls = CLASS_OF_KIND.get(op.kind)
        if cls is None or op.link_bytes <= 0:
            continue
        coll_bytes += op.link_bytes
        matches = [a for a, k in sizes.items() if k == op.group]
        if not matches and op.group >= total_devices:
            matches = list(sizes)  # global collective: spans every axis
        if not matches:
            # group spans a product of axes (e.g. 512 = pod*data*model slice)
            matches = [max(sizes, key=sizes.get)]
        share = op.link_bytes / len(matches)
        for a in matches:
            key = (cls, a)
            out[key] = out.get(key, 0.0) + share
    return MeshProfile(
        axis_sizes=sizes,
        class_axis_bytes=out,
        local_bytes=max(analysis.hbm_bytes - coll_bytes, 0.0),
        flops=analysis.flops,
    )


@dataclass
class MeshSignature:
    """Fitted signature: per (class, axis) base bytes + scaling exponent.

    ``beta`` is the full-tensor bytes behind the collective (so the
    per-axis link bytes at axis size k with b batch shards are
    ``class_factor(cls, k) * beta / b**e``).
    """

    terms: dict[tuple[str, str], tuple[float, float]]  # (cls, axis) -> (beta, e)
    local_bytes0: float  # local bytes at the reference batch-shard count
    flops0: float
    batch_shards0: int  # reference number of batch shards (data axis)

    def predict_axis_bytes(self, axis_sizes: dict[str, int]) -> dict[str, float]:
        b = axis_sizes.get("data", 1) * axis_sizes.get("pod", 1)
        out: dict[str, float] = {a: 0.0 for a in axis_sizes}
        for (cls, axis), (beta, e) in self.terms.items():
            if axis not in axis_sizes:
                continue
            k = axis_sizes[axis]
            out[axis] += class_factor(cls, k) * beta / (b / self.batch_shards0) ** e
        return out

    def predict_local_bytes(self, axis_sizes: dict[str, int]) -> float:
        # compute-local traffic scales with per-device work (1/batch shards)
        b = axis_sizes.get("data", 1) * axis_sizes.get("pod", 1)
        return self.local_bytes0 * self.batch_shards0 / b

    def class_fractions(self) -> dict[str, float]:
        """The paper-style signature view: fraction of traffic per class."""
        totals: dict[str, float] = {}
        for (cls, _), (beta, _) in self.terms.items():
            totals[cls] = totals.get(cls, 0.0) + beta
        totals["local"] = self.local_bytes0
        s = sum(totals.values()) or 1.0
        return {k: v / s for k, v in totals.items()}


def fit_mesh_signature(sym: MeshProfile, asym: MeshProfile) -> MeshSignature:
    """The 2-run fit.

    The asymmetric profile attributes axes exactly; the symmetric profile
    supplies the second equation per term that identifies the batch-scaling
    exponent ``e`` (model selection over {0, 1}, then beta re-fit) — the
    mesh analogue of §5.4/§5.5's rearrangements.
    """
    b_sym = sym.axis_sizes.get("data", 1) * sym.axis_sizes.get("pod", 1)
    b_asym = asym.axis_sizes.get("data", 1) * asym.axis_sizes.get("pod", 1)

    terms: dict[tuple[str, str], tuple[float, float]] = {}
    keys = set(asym.class_axis_bytes) | set(sym.class_axis_bytes)
    for cls, axis in keys:
        k_asym = asym.axis_sizes.get(axis, 1)
        k_sym = sym.axis_sizes.get(axis, 1)
        y_asym = asym.class_axis_bytes.get((cls, axis), 0.0)
        y_sym = sym.class_axis_bytes.get((cls, axis), 0.0)
        f_asym = class_factor(cls, k_asym)
        f_sym = class_factor(cls, k_sym)
        if f_asym <= 0 or y_asym <= 0:
            continue
        beta_asym = y_asym / f_asym  # base bytes implied by the asym run
        if y_sym > 0 and f_sym > 0 and b_sym != b_asym:
            beta_sym = y_sym / f_sym
            # choose the exponent that best reconciles the two runs
            best_e, best_err = 0.0, float("inf")
            for e in (0.0, 1.0):
                pred_sym = beta_asym * (b_asym / b_sym) ** e
                err = abs(math.log(max(pred_sym, 1e-30) / max(beta_sym, 1e-30)))
                if err < best_err:
                    best_e, best_err = e, err
            # re-fit beta at the symmetric reference (geometric mean)
            beta0 = math.sqrt(
                beta_sym * beta_asym * (b_asym / b_sym) ** best_e
            )
            terms[(cls, axis)] = (beta0, best_e)
        else:
            terms[(cls, axis)] = (beta_asym, 0.0)
    return MeshSignature(
        terms=terms,
        local_bytes0=sym.local_bytes,
        flops0=sym.flops,
        batch_shards0=b_sym,
    )
