"""Bandwidth-signature engine — the paper's core contribution (port of
``repro.core.bwsig``).  Consumes performance-counter samples
(:class:`CounterSample`) and produces/consumes bandwidth signatures
(:class:`BandwidthSignature`)."""

from repro_torch.core.bwsig.signature import (
    BandwidthSignature,
    DirectionSignature,
    interleaved_fraction,
    placement_matrix,
    predict_counters,
    predict_flows,
)
from repro_torch.core.bwsig.counters import CounterSample, counters_from_flows
from repro_torch.core.bwsig.fit import (
    fit_direction,
    fit_signature,
    normalize_sample,
)
from repro_torch.core.bwsig.detect import misfit_score, signature_distance

__all__ = [
    "BandwidthSignature",
    "DirectionSignature",
    "CounterSample",
    "counters_from_flows",
    "interleaved_fraction",
    "placement_matrix",
    "predict_counters",
    "predict_flows",
    "fit_direction",
    "fit_signature",
    "normalize_sample",
    "misfit_score",
    "signature_distance",
]
