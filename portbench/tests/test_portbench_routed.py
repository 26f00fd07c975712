"""The ``hybrid`` family and the ``prefill_routed`` cell on the CPU at
tiny widths: a whole run is correct and its replay bit-equal, a replay
that differs fails every checked request, the float8 control reads well
above the program, the family's work holds the stage's operations, and
``moe_roofline_pct`` reads the expert kernels by name."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest

from portbench import check, harness
from portbench import work as W
from portbench.cells import prefill_routed
from portbench.families import hybrid as fam
from portbench.metrics import moe_roofline_pct
from portbench.tests import _tiny
from portbench.tests._tiny_hybrid import HYBRID

LIMITS = {"check_requests": 3, "numbers": dict(_tiny.PREFILL_LIMITS["numbers"],
                                               route_margin={"limit": 1.0})}


def _cell():
    return dataclasses.replace(_tiny.cell(HYBRID, "prefill"), limits=LIMITS,
                               traffic=dict(_tiny.PREFILL, kind="prefill_routed"))


def test_sound_run_is_correct_and_replays_bit_equal():
    cell = _cell()
    out = harness.run_cell(cell)
    ok, _ = check.verdict(out.numbers, cell.limits)
    assert ok and out.failed == 0 and out.attempted > 0, out.numbers
    assert out.notes["replay_bit_equal"] and set(out.numbers) == {"logit_err", "greedy_gap",
                                                                   "route_margin"}


def test_a_replay_that_differs_fails_every_checked_request(monkeypatch):
    from repro_torch.launch import steps
    from repro_torch.models import moe

    make = steps.make_prefill_step

    def drifting(cfg):
        step = make(cfg)

        def served(params, batch):
            out = step(params, batch)
            recording = getattr(moe._TALLY, "choices", None) is not None  # the replay
            return out * 1.01 if recording else out

        return served

    monkeypatch.setattr(steps, "make_prefill_step", drifting)
    out = harness.run_cell(_cell())
    assert not out.notes["replay_bit_equal"] and out.failed == LIMITS["check_requests"]


def test_float8_control_reads_above_the_program():
    cell = _cell()
    program = harness.run_cell(cell).numbers
    control = prefill_routed.control_readings(cell)["fp8"]
    assert any(control[k] >= 3 * max(program[k], 1e-6) for k in ("logit_err", "greedy_gap")), (
        program, control)


@pytest.mark.parametrize("S", [16, 64])
def test_prefill_work_holds_the_stage_operations(S):
    """The family's whole ``"gemm"`` list and its mean layer times the
    layers count the same operations; the experts' bytes hold every
    expert's weights once a product."""
    cfg = HYBRID
    work = W.prefill_work(cfg, 1, S)
    mean = sum(2 * S * k * n for _, k, n in fam.products(cfg)) * cfg["n_layers"]
    head = 2 * cfg["d_model"] * W.padded_vocab(cfg)
    assert sum(w.ops for w in work["gemm"]) == mean + head
    assert len(work["k1"]) == 1 and len(work["k2"]) == 7
    gate = fam.expert_work(cfg, S)[0]
    assert gate.nbytes >= 2 * cfg["n_experts"] * cfg["d_model"] * cfg["d_ff"]


def test_moe_roofline_reads_the_grouped_kernels():
    names = {"gemm": {"_ZN7cutlass13device_kernelI...GroupProblemShape...": [3, 0.004],
                      "void at::cuda::detail::prepare_grouped_gemm_data<...>": [3, 0.001],
                      "nvjet_tst_256x128": [9, 0.5]}}
    r = SimpleNamespace(trace=SimpleNamespace(names=names, info={"expert_least_s": 0.003}))
    assert moe_roofline_pct.read(r) == pytest.approx(60.0)
    r.trace.info = {"requests": 8}
    assert moe_roofline_pct.read(r) is None
