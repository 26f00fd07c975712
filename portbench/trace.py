"""The device trace of a traced window, read from ``torch.profiler``.

:func:`trace_window` runs the window under the profiler with CUDA
activity alone, so the host pays no more than the profiler's kernel
records and the window's idle share is the program's, and reduces the
trace to what the per-layer metrics and the result's ``device`` and
``breakdown`` keys need: each device operation's interval and class, the
union of the intervals (``busy_s``), the window's length on the host's
clock (``window_s``) and the operations that took most time.  The
profiler can drop kernels from a trace, so a window whose K1 and K2
counts differ from the kernels' own launch counters is traced again, up
to ``TRIES`` times; a trace still short is an error rather than a short
device time.  A shorter window before it, traced with the host's
activity too, names the longest idle gaps by what the host was doing
when each ended (recording every host operation slows the host, so that
window's gaps are longer than the measured window's; their names are
what it is for).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable

import torch

from portbench.kernels import CLASSES, classify

TRIES = 3
TOP = 10
# prefix of the benchmark's own spans (``torch.profiler.record_function``)
SPAN = "portbench."


@dataclass
class Trace:
    window_s: float
    busy_s: float
    class_s: dict[str, float]
    class_count: dict[str, int]
    names: dict[str, dict[str, list]]  # class -> name -> [count, seconds]
    device_ops: list[list]  # [name, seconds], most time first
    idle_gaps: list[list]  # [host activity, seconds], longest first
    info: dict = field(default_factory=dict)  # what the window did (steps, requests, ...)


def _union_s(spans: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def _host_activity(cpu: list[tuple[float, float, str]], starts: list[float], t: float) -> str:
    """What the host ran at ``t`` (us): the innermost operation whose
    interval holds ``t``, under the benchmark's own span that holds it."""
    i = bisect.bisect_right(starts, t) - 1
    inner, outer = None, None
    while i >= 0:
        start, stop, name = cpu[i]
        if stop >= t:
            if name.startswith(SPAN):
                outer = name[len(SPAN):]
                break
            if inner is None and not name.startswith("cuda"):
                inner = name
        i -= 1
    return f"{outer or 'host'}/{inner or 'idle'}"


def read(prof, window_s: float) -> Trace:
    """The trace of ``prof``'s window, ``window_s`` long."""
    from torch.autograd import DeviceType

    device, cpu = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type != DeviceType.CUDA:
            cpu.append(span)
        elif not (e.name.startswith(SPAN) or getattr(e, "is_user_annotation", False)):
            device.append(span)  # the benchmark's spans show on the device's timeline too
    device.sort()
    cpu.sort()
    names: dict[str, dict[str, list]] = {c: {} for c in CLASSES}
    per_op: dict[str, float] = defaultdict(float)
    for start, stop, name in device:
        cls = classify(name)
        entry = names[cls].setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (stop - start) / 1e6
        per_op[name] += (stop - start) / 1e6
    gaps, end = [], None
    for start, stop, _ in device:
        if end is not None and start > end:
            gaps.append((start - end, start))
        end = stop if end is None else max(end, stop)
    gaps.sort(reverse=True)
    starts = [s for s, _, _ in cpu]
    named: dict[str, float] = defaultdict(float)
    for length, at in gaps[: 5 * TOP]:
        named[_host_activity(cpu, starts, at - 1.0)] += length / 1e6
    return Trace(
        window_s=window_s,
        busy_s=_union_s([(s, e) for s, e, _ in device]) / 1e6,
        class_s={c: sum(v[1] for v in names[c].values()) for c in CLASSES},
        class_count={c: sum(v[0] for v in names[c].values()) for c in CLASSES},
        names=names,
        device_ops=[[n, s] for n, s in sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[n, s] for n, s in sorted(named.items(), key=lambda kv: -kv[1])[:TOP]],
    )


def launch_counts() -> dict[str, int]:
    """The port's own launch counters of K1's and K2's kernels: the trace
    must list as many (K1's backward is three kernels a call)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.kernels.mamba_scan.kernel import selective_scan, selective_scan_bwd

    return {"k1": flash_attention.launches + 3 * flash_attention_bwd.launches,
            "k2": selective_scan.launches + selective_scan_bwd.launches}


def trace_window(body: Callable[[], dict], names_body: Callable[[], dict]) -> Trace:
    """Run ``names_body`` traced with the host's activity too, for the
    names of the idle gaps; then ``body`` (a whole traced window; it
    returns what it did) under the profiler with CUDA activity alone, and
    read its trace, tracing it again while the trace lists fewer K1 or K2
    kernels than were launched."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        names_body()
        torch.cuda.synchronize()
    idle_gaps = read(prof, time.perf_counter() - t0).idle_gaps
    seen = []
    for _ in range(TRIES):
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            info = body()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        after = launch_counts()
        trace = read(prof, window_s)
        want = {k: after[k] - before[k] for k in after}
        got = {k: trace.class_count[k] for k in want}
        seen.append(got)
        if got == want:
            trace.info = {**info, "kernel_counts": got, "traces": len(seen)}
            trace.idle_gaps = idle_gaps
            return trace
    raise RuntimeError(f"the profiler listed K1/K2 kernels {seen} in {TRIES} traces; "
                       f"their launch counters say {want}")
