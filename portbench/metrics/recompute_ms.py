"""``recompute_ms``: the device ms of the operations launched under the
program's ``recompute`` span (the layer groups' forwards again in the
backward, K1's and K2's among them), a mean over the steps of the window
that read the spans (``portbench/spans.py``)."""

from portbench.spans import per_unit


def read(r):
    s = per_unit(r.trace, ("recompute",))
    return None if s is None else 1e3 * s
