"""``gemm_roofline_pct``: the least time of the model's products (each the
larger of its operations at the bf16 peak and its operands read and
result written once at the HBM rate) over the device time of cuBLAS's
kernels in the trace, in %.  The recompute's products are time, not
work."""

from portbench import work as W


def read(r):
    if r.trace is None or not r.work or not r.work["gemm"] or r.trace.class_s["gemm"] <= 0:
        return None
    return 100.0 * W.least_s(r.work["gemm"]) / r.trace.class_s["gemm"]
