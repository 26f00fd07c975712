"""Which class a device operation of the trace belongs to, by its name.

This is the one place that names the kernels: ``k1`` (the port's flash
attention forward and backward), ``k2`` (its selective scan forward and
backward), ``gemm`` (cuBLAS's products and their split-K reductions),
and ``other`` (elementwise work, casts, reductions, the depthwise conv,
the optimizer, copies and fills).  A traced run prints the names each
class matched on an earlier line, so a new kernel name shows.
"""

from __future__ import annotations

CLASSES = ("k1", "k2", "gemm", "other")

# substrings, tested on the lower-cased name in this order
_K1 = ("flash_fwd", "flash_bwd")
_K2 = ("selective_scan",)
# cuDNN's convolutions are implicit GEMMs: they are the conv, not a product
_NOT_GEMM = ("conv", "fprop", "dgrad", "wgrad")
_GEMM = ("gemm", "nvjet", "splitkreduce", "cutlass")


def classify(name: str) -> str:
    low = name.lower()
    if any(s in low for s in _K1):
        return "k1"
    if any(s in low for s in _K2):
        return "k2"
    if any(s in low for s in _NOT_GEMM):
        return "other"
    if any(s in low for s in _GEMM):
        return "gemm"
    return "other"
