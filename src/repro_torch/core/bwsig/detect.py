"""Detecting workloads the model cannot represent — paper §6.2.1 (port of
``repro.core.bwsig.detect``).

Once the static fraction is removed from the symmetric run, every bank's
residual total and remote ratio must be equal for a model-representable
workload; the spread of both is the misfit score.
"""

from __future__ import annotations

import torch

from repro_torch.core.bwsig.counters import CounterSample
from repro_torch.core.bwsig.fit import fit_static, normalize_sample
from repro_torch.core.bwsig.signature import (
    BandwidthSignature,
    DirectionSignature,
    interleaved_fraction,
)

_EPS = 1e-20


def misfit_score(sym_sample: CounterSample, direction: str = "read") -> torch.Tensor:
    """Redundancy check on the *symmetric* profiling run: combined
    normalized spread of the per-bank residual totals and remote ratios;
    0 = perfect fit, larger = worse.  Leading batch dimensions pass
    through."""
    sym = normalize_sample(sym_sample, direction)
    static_socket, static_fraction = fit_static(sym)

    local, remote = sym["local"], sym["remote"]
    s = local.shape[-1]
    total = torch.clamp((local + remote).sum(dim=-1), min=_EPS)
    static_total = (static_fraction * total)[..., None]
    onehot = torch.arange(s, device=local.device) == static_socket[..., None]
    local = torch.clamp(torch.where(onehot, local - static_total / s, local), min=0.0)
    remote = torch.clamp(
        torch.where(onehot, remote - static_total * (s - 1) / s, remote), min=0.0
    )

    residual_totals = local + remote
    mean_total = torch.clamp(residual_totals.mean(dim=-1, keepdim=True), min=_EPS)
    total_spread = (
        torch.abs(residual_totals - mean_total).amax(dim=-1) / mean_total[..., 0]
    )

    r = remote / torch.clamp(local + remote, min=_EPS)
    r_spread = torch.abs(r - r.mean(dim=-1, keepdim=True)).amax(dim=-1)

    return total_spread + r_spread


def _class_vector(sig: DirectionSignature, s: int) -> torch.Tensor:
    """One slot per possible static socket + local + per-thread +
    interleaved: moving the static socket reallocates all of its
    bandwidth."""
    cols = torch.arange(s, device=sig.static_fraction.device)
    static = (cols == sig.static_socket[..., None]) * sig.static_fraction[..., None]
    rest = torch.stack(
        [sig.local_fraction, sig.per_thread_fraction, interleaved_fraction(sig)],
        dim=-1,
    )
    return torch.cat([static, rest], dim=-1)


def signature_distance(
    a: BandwidthSignature | DirectionSignature,
    b: BandwidthSignature | DirectionSignature,
    s: int = 2,
) -> torch.Tensor:
    """Fraction of the bandwidth reallocated between two signatures (paper
    Figure 14) — half the L1 distance between the class distributions."""
    if isinstance(a, BandwidthSignature):
        if not isinstance(b, BandwidthSignature):
            raise TypeError("both signatures must be BandwidthSignature")
        return 0.5 * (
            signature_distance(a.read, b.read, s)
            + signature_distance(a.write, b.write, s)
        )
    va = _class_vector(a, s)
    vb = _class_vector(b, s)
    return 0.5 * torch.abs(va - vb).sum(dim=-1)
