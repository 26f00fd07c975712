"""A whole run of each kind of cell on the CPU, past the harness's look
for a card, with the timed path broken underneath: ``correct`` comes out
false for each fault the cell can have (a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest; an
answer altered where it is produced), and true for the sound path.  One
card, so no exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from portbench import check, harness
from portbench.tests import _tiny


def _verdict(cell):
    out = harness.run_cell(cell)
    ok, _ = check.verdict(out.numbers, cell.limits)
    return ok and out.failed == 0, out


@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_sound_run_is_correct(family, kind):
    ok, out = _verdict(_tiny.cell(_tiny.CONFIGS[family], kind))
    assert ok, out.numbers
    assert out.attempted > 0


def _unchanged(make):
    def make_step(cfg, **kw):
        step = make(cfg, **kw)

        def broken(params, opt, batch, s):
            keep = [t.detach().clone() for t in params.parameters()]
            out = step(params, opt, batch, s)
            with torch.no_grad():
                for p, k in zip(params.parameters(), keep):
                    p.copy_(k)
            return out

        return broken

    return make_step


def _half_batch(make):
    def make_step(cfg, **kw):
        step = make(cfg, **kw)

        def broken(params, opt, batch, s):
            half = batch["tokens"].shape[0] // 2
            return step(params, opt, {k: v[:half] for k, v in batch.items()}, s)

        return broken

    return make_step


def _altered_answer(make):
    def make_step(cfg):
        step = make(cfg)

        def broken(params, batch):
            logits = step(params, batch)
            logits[:, 7] += 4.0
            return logits

        return broken

    return make_step


@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("fault,kind,maker", [
    ("state_unchanged", "train", _unchanged),
    ("half_batch", "train", _half_batch),
    ("answer_altered", "prefill", _altered_answer),
])
def test_fault_is_caught(monkeypatch, family, fault, kind, maker):
    from repro_torch.launch import steps

    name = "make_train_step" if kind == "train" else "make_prefill_step"
    monkeypatch.setattr(steps, name, maker(getattr(steps, name)))
    ok, out = _verdict(_tiny.cell(_tiny.CONFIGS[family], kind))
    assert not ok, (fault, out.numbers)
