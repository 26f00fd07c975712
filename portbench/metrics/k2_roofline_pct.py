"""``k2_roofline_pct``: K2's least time (the larger of its function's
bytes at the HBM rate and its operations at the float32 peak, forward and
backward) over the device time of every K2 kernel in the trace, the
recompute's forwards among them, in %.  Nothing to read in a cell without
a mamba mixer."""

from portbench import work as W


def read(r):
    if r.trace is None or not r.work or not r.work.get("k2") or r.trace.class_s["k2"] <= 0:
        return None
    return 100.0 * W.least_s(r.work["k2"]) / r.trace.class_s["k2"]
