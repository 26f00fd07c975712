"""``other_kernels_pct``: the share of the trace's device time spent in
operations that are neither cuBLAS's products nor K1 or K2 (elementwise
work, casts, reductions, the conv, the optimizer, copies), in %
(``portbench/kernels.py`` classifies them by name)."""


def read(r):
    if r.trace is None:
        return None
    total = sum(r.trace.class_s.values())
    return 100.0 * r.trace.class_s["other"] / total if total > 0 else None
