"""``moe_route_ms``: the device ms of the operations launched under the
program's ``moe.route`` span (the router's float32 product and softmax,
the top-k, the sort of the (token, choice) pairs by expert and the
gather of their rows), a mean over the requests of the window that read
the spans (``portbench/spans.py``)."""

from portbench.spans import per_unit


def read(r):
    s = per_unit(r.trace, ("moe.route",))
    return None if s is None else 1e3 * s
