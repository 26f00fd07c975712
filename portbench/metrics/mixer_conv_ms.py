"""``mixer_conv_ms``: the device ms of the operations launched under the
program's ``mamba.conv`` span (the mixer's causal depthwise conv, its
padding and its SiLU), a mean over the requests of the window that read
the spans (``portbench/spans.py``)."""

from portbench.spans import per_unit


def read(r):
    s = per_unit(r.trace, ("mamba.conv",))
    return None if s is None else 1e3 * s
