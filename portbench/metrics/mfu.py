"""``mfu``: the model's operations in the traced window (the products'
and attention's, without the layer groups' recompute; ``work.py``) over
the window's time at the published dense bf16 peak, in %."""

from portbench import work as W


def read(r):
    if r.trace is None or not r.work or r.trace.window_s <= 0:
        return None
    return 100.0 * W.model_ops(r.work) / (r.trace.window_s * W.BF16_OPS_PER_S)
