"""``cast_ms``: the device ms of the compute cast (the program's ``cast``
span), of its backward to the float32 masters (``cast.backward``) and of
the autograd engine's adds into the masters' ``.grad`` inside the step
(``AccumulateGrad``), a mean over the steps of the window that read the
spans (``portbench/spans.py``)."""

from portbench.spans import per_unit


def read(r):
    s = per_unit(r.trace, ("cast", "cast.backward", "AccumulateGrad"))
    return None if s is None else 1e3 * s
