"""The control and the planted fault at a size a test run can hold: the
reference with float8 products reads well above the bf16 program on at
least one compared number, and so does the reference with half of each
batch left out.  (At the cells' own sizes they are read on the card by
``portbench/controls.py``; PERF.md gives those readings.)"""

from __future__ import annotations

import pytest

from portbench import controls, harness
from portbench.tests import _tiny


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_prefill_control_fails_where_the_program_passes(family):
    cell = _tiny.cell(_tiny.CONFIGS[family], "prefill")
    program = harness.run_cell(cell).numbers
    control = controls.prefill_readings(cell)["fp8"]
    assert any(control[k] >= 3 * max(program[k], 1e-6) for k in control), (program, control)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_train_control_and_half_batch_fail_where_the_program_passes(family):
    cell = _tiny.cell(_tiny.CONFIGS[family], "train")
    program = harness.run_cell(cell).numbers
    readings = controls.train_readings(cell)
    for label in ("fp8", "half_batch"):
        got = readings[label]
        assert any(got[k] >= 3 * program[k] for k in got), (label, program, got)
