"""The program's own spans in a traced window, with the device work each
launched.

The port opens ``repro_torch.<name>`` ranges while a profiler records
(``repro_torch.runtime.trace.span``): ``train_step``, ``cast``,
``cast.backward``, ``recompute``, ``optimizer``, ``prefill`` and
``mamba.conv``.  :func:`read` attributes each device operation of a
trace that holds the host's activity by its launch: the CUDA runtime or
driver call that shares its correlation id, on the thread that made it.
The operation counts under every program span open at that moment on
that thread (the innermost is its own, ``self_s``) and on the others (the
step's span, on the thread that waits while autograd's thread runs the
backward, the recompute and the cast's backward), and under the autograd
engine's ``AccumulateGrad`` range on its thread while a ``train_step``
is open: the adds into the float32 masters' ``.grad``.  Spans are never
device operations, though the profiler shows them on the device's
timeline too.

:func:`host_window` traces a window with the host's activity, checked
and traced again as ``portbench.trace`` checks its measured window, and
reads both its trace and its spans.  The readers of ``optimizer_ms``,
``cast_ms``, ``recompute_ms``, ``mixer_conv_ms`` and ``launches`` take
the spans as ``trace.spans`` and what their window did as
``trace.span_window`` (:func:`per_unit`); they read nothing until
``portbench.trace.trace_window`` runs its host window through
:func:`host_window` and keeps both.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable

import torch

from portbench import trace as T

PROGRAM = "repro_torch."
# the autograd engine's range around an add into a leaf's ``.grad``
GRAD_ADD = "torch::autograd::AccumulateGrad"
STEP = PROGRAM + "train_step"


def _attribute(ranges: list[tuple[float, float, str, int]],
               launched: list[tuple[float, int, float]]) -> dict:
    """Each span name's ``count``, and the ``ops`` and ``device_s`` of the
    device operations launched under it, ``self_s`` where it was the
    innermost on the launching thread, and ``ops_each`` ({ops: instances}).
    ``ranges``: (start, stop, name, thread) of the program spans and the
    ``GRAD_ADD`` ranges; ``launched``: (launch time, thread, device
    seconds) of each operation."""
    marks = sorted([(start, 0, r) for r, (start, _, _, _) in enumerate(ranges)]
                   + [(stop, 2, r) for r, (_, stop, _, _) in enumerate(ranges)]
                   + [(t, 1, k) for k, (t, _, _) in enumerate(launched)])
    open_on: dict[int, list[int]] = defaultdict(list)  # thread -> open ranges, outermost first
    ops_of = [0] * len(ranges)
    out: dict[str, dict] = {}

    def entry(name: str) -> dict:
        short = "AccumulateGrad" if name == GRAD_ADD else name[len(PROGRAM):]
        return out.setdefault(short, {"count": 0, "ops": 0, "device_s": 0.0, "self_s": 0.0,
                                      "ops_each": defaultdict(int)})

    for _, order, x in marks:  # at one time: opens, then launches, then closes
        if order == 0:
            open_on[ranges[x][3]].append(x)
        elif order == 2:
            open_on[ranges[x][3]].remove(x)
        else:
            _, thread, seconds = launched[x]
            own = [r for r in reversed(open_on[thread]) if ranges[r][2] != GRAD_ADD]
            held = own + [r for t, rs in open_on.items() if t != thread for r in rs
                          if ranges[r][2] != GRAD_ADD]
            adds = [r for r in open_on[thread] if ranges[r][2] == GRAD_ADD]
            if adds and any(ranges[r][2] == STEP for r in held):
                held.append(adds[-1])
            for r in held:
                ops_of[r] += 1
            for name in {ranges[r][2] for r in held}:
                e = entry(name)
                e["ops"] += 1
                e["device_s"] += seconds
            if own:
                entry(ranges[own[0]][2])["self_s"] += seconds
    steps = [(start, stop) for start, stop, name, _ in ranges if name == STEP]
    for r, (start, stop, name, _) in enumerate(ranges):
        if name != GRAD_ADD or any(s <= start and stop <= e for s, e in steps):
            e = entry(name)
            e["count"] += 1
            e["ops_each"][ops_of[r]] += 1
    for e in out.values():
        e["ops_each"] = {str(n): c for n, c in sorted(e["ops_each"].items())}
    return out


def read(prof) -> dict:
    """The spans of ``prof``'s trace (a trace with the host's activity):
    :func:`_attribute`'s entries by span name less ``repro_torch.``,
    ``AccumulateGrad`` for the gradient adds, and ``unlinked``: the
    device operations whose launch the trace does not hold."""
    from torch.autograd import DeviceType

    ranges, launches, device = [], {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            if e.name.startswith(PROGRAM) or e.name == GRAD_ADD:
                ranges.append((e.time_range.start, e.time_range.end, e.name, e.thread))
            elif e.name.startswith("cu"):  # a CUDA runtime or driver call
                launches[e.id] = (e.time_range.start, e.thread)
        elif not (e.name.startswith((T.SPAN, PROGRAM)) or getattr(e, "is_user_annotation", False)):
            device.append(e)
    launched, unlinked = [], []
    for e in device:
        seconds = (e.time_range.end - e.time_range.start) / 1e6
        if e.id in launches:
            launched.append((*launches[e.id], seconds))
        else:
            unlinked.append(seconds)
    out = {k: v for k, v in _attribute(ranges, launched).items()
           if k != "AccumulateGrad" or v["count"]}
    out["unlinked"] = {"ops": len(unlinked), "device_s": sum(unlinked)}
    return out


def host_window(run: Callable[[], dict]) -> tuple[T.Trace, dict]:
    """``run`` (it returns what it did) traced with the host's activity
    and the device's: its trace (``portbench.trace.read``) and its spans,
    traced again while the trace lists fewer K1 or K2 kernels than were
    launched, up to ``portbench.trace.TRIES`` times."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(T.TRIES):
        before = T.launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            info = run()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        after = T.launch_counts()
        trace = T.read(prof, window_s)
        want = {k: after[k] - before[k] for k in after}
        got = {k: trace.class_count[k] for k in want}
        seen.append(got)
        if got == want:
            trace.info = {**info, "kernel_counts": got, "traces": len(seen)}
            return trace, read(prof)
    raise RuntimeError(f"the profiler listed K1/K2 kernels {seen} in {T.TRIES} host traces; "
                       f"their launch counters say {want}")


def per_unit(trace, names: tuple[str, ...], key: str = "device_s") -> float | None:
    """``key`` summed over the spans ``names``, over the steps or requests
    of the window that read them; ``None`` where the first is absent (a
    program without it, or a trace without spans)."""
    spans = getattr(trace, "spans", None) or {}
    if names[0] not in spans:
        return None
    window = trace.span_window
    return sum(spans[n][key] for n in names if n in spans) / (window.get("steps")
                                                            or window["requests"])
