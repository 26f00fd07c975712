"""The comparison that decides ``correct``: the numbers a run compares
with the reference, and their limits (``portbench/limits/<cell>.json``).

Prefill: over a sample of the window's finished requests, drawn from the
seed with the longest among them, each request's last-position logits
(the real vocabulary) against the float32 reference's:

* ``logit_err``: the widest ``max |program - reference|`` over the
  reference's ``max |reference|``;
* ``greedy_gap``: the widest gap by which the logit of the program's
  greedy token lies below the reference's best.

Training: the first steps, which set-up drives through the window's own
step, against the reference's same steps:

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_gap``: over the leaves, the widest gap between the norms of the
  program's and the reference's first clipped gradient (the program's
  read from AdamW's first moment after one step), over the larger of the
  reference leaf's norm and the median leaf's;
* ``update_gap``: the same for the norm of each leaf's change over the
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move under AdamW by round-off).
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import torch

DIR = Path(__file__).resolve().parent / "limits"
QUIET = 1e-3  # a leaf whose first gradient is under this share of the median's is left out


def load_limits(workload: str) -> dict:
    return json.loads((DIR / f"{workload}.json").read_text())


def prefill_numbers(pairs: list[tuple[torch.Tensor, torch.Tensor]]) -> dict[str, float]:
    """``pairs``: (program logits, reference logits) over the real
    vocabulary, one pair a sampled request."""
    err = gap = 0.0
    for got, want in pairs:
        got, want = got.float(), want.float()
        err = max(err, float((got - want).abs().max() / want.abs().max()))
        gap = max(gap, float(want.max() - want[int(got.argmax())]))
    return {"logit_err": err, "greedy_gap": gap}


def _worst(got: dict[str, float], want: dict[str, float], names) -> float:
    floor = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], floor, 1e-30) for n in names)


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref`` as :func:`portbench.reference.train.run`
    returns them."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    names = sorted(ref["grad1"])
    median = statistics.median(ref["grad1"][n] for n in names)
    moving = [n for n in names if ref["grad1"][n] >= QUIET * median]
    return {"loss_gap": loss, "grad_gap": _worst(prog["grad1"], ref["grad1"], names),
            "update_gap": _worst(prog["change"], ref["change"], moving)}


def verdict(numbers: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    the cell's limits name is finite and within its limit.  A number they
    do not name has no upper reading in that cell (PERF.md gives its
    readings) and is not compared."""
    checks = {}
    ok = True
    for name, entry in limits["numbers"].items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": entry["limit"]}
        ok &= value == value and value <= entry["limit"]
    return ok, checks
