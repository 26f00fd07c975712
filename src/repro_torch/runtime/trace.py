"""Named spans inside the port's steps, for ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function("repro_torch." + name)``
while a profiler records, on this thread or the one whose autograd work
this thread runs, and one shared no-op context otherwise: there is no
switch of its own, so the spans appear in whatever a profiler records
(the device operations each span's host calls launch included) and cost
one check of the profiler's state when none does.

The spans: ``train_step`` (``launch/steps.py::make_train_step``'s step),
``cast`` (``models/model.py::cast_for_compute`` building the compute
copy) and ``cast.backward`` (the training cast's gradient back to each
master leaf's dtype, on autograd's thread), ``recompute`` (a layer
group's recompute in the backward, on autograd's thread), ``optimizer``
(the accumulation's division, the clip, the schedule and AdamW),
``prefill`` (``make_prefill_step``'s step), ``mamba.conv`` (the
mixer's causal conv and its SiLU) and, in a one-device MoE layer,
``moe.route`` (the router, its top-k and the dispatch of the tokens to
the experts), ``moe.experts`` (the experts' products) and ``moe.combine``
(each token's weighted sum of its choices).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd.profiler import record_function

PREFIX = "repro_torch."
OFF = contextlib.nullcontext()  # reentrant: one instance serves every span


def span(name: str):
    """The span ``repro_torch.<name>`` while a profiler records, else
    :data:`OFF`."""
    if torch._C._autograd._profiler_enabled():
        return record_function(PREFIX + name)
    return OFF
