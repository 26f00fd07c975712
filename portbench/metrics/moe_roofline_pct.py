"""``moe_roofline_pct``: the experts' least time over the traced requests
(``expert_least_s``, which a routed prefill cell's traced body returns:
the operations of k choices a token at the bf16 peak, or every expert's
weights read once, the larger, every MoE layer) over the device time of
the expert kernels in the trace (the grouped products and the kernel
that prepares their problem list, matched by name among the products),
in %.  Nothing to read in a cell without experts."""

# substrings of the lower-cased names of the grouped products' kernels
EXPERT_KERNELS = ("groupproblemshape", "grouped_gemm")


def read(r):
    if r.trace is None or not r.trace.info.get("expert_least_s"):
        return None
    device_s = sum(s for name, (_, s) in r.trace.names.get("gemm", {}).items()
                   if any(k in name.lower() for k in EXPERT_KERNELS))
    return 100.0 * r.trace.info["expert_least_s"] / device_s if device_s > 0 else None
