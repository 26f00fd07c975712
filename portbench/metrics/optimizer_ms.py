"""``optimizer_ms``: the device ms of the operations launched under the
program's ``optimizer`` span (the accumulation's division, the clip, the
schedule and AdamW), a mean over the steps of the window that read the
spans (``portbench/spans.py``)."""

from portbench.spans import per_unit


def read(r):
    s = per_unit(r.trace, ("optimizer",))
    return None if s is None else 1e3 * s
