"""``k1_roofline_pct``: K1's least time (its forward's 4 dh operations a
visible pair, 2.5 times that for its backward, at the bf16 peak, or its
bytes) over the device time of every K1 kernel in the trace, the
recompute's forwards among them, in %.  Nothing to read in a cell without
attention."""

from portbench import work as W


def read(r):
    if r.trace is None or not r.work or not r.work.get("k1") or r.trace.class_s["k1"] <= 0:
        return None
    return 100.0 * W.least_s(r.work["k1"]) / r.trace.class_s["k1"]
