"""``launches``: the device operations (kernels, copies, fills) launched
under the program's ``train_step`` span, on its thread and autograd's, or
its ``prefill`` span, a mean over the steps or requests of the window
that read the spans (``portbench/spans.py``)."""

from portbench.spans import per_unit


def read(r):
    for name in ("train_step", "prefill"):
        n = per_unit(r.trace, (name,), "ops")
        if n is not None:
            return n
    return None
