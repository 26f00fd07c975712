"""A traced run of each kind of cell on the card at a tiny size: the
kernels launch, the trace lists them, the readers give numbers within
their ranges.  Needs a CUDA card (``-m gpu``); skipped without one."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import harness
from portbench.tests import _tiny


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_traced_tiny_cell_on_the_card(family, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = dataclasses.replace(_tiny.cell(_tiny.CONFIGS[family], kind), device="cuda",
                               trace=True)
    out = harness.run_cell(cell)
    spec = harness.load_spec()
    cell.workload = {("train", "dense"): "danube_train_4k", ("train", "ssm"): "falcon8_train_4k",
                     ("prefill", "dense"): "danube_prefill_mix",
                     ("prefill", "ssm"): "falcon_prefill_mix"}[(kind, family)]
    result, _ = harness.result_line(spec, cell, out)
    assert result["correct"], result["checks"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name, m in result["metrics"].items():
        assert 0 <= m["value"] <= (100 if m["unit"] == "%" else float("inf")), name
