"""The program's spans read from a synthetic trace (``portbench/spans.py``):
attribution by launch across the main and autograd threads, the
gradient adds, annotations kept off the device operations, the readers
of the span metrics, and ``portbench/trace.py``'s fields unchanged by the
program's spans."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import spans as S
from portbench import trace as T
from portbench.metrics import cast_ms, launches, mixer_conv_ms, optimizer_ms, recompute_ms

MAIN, AUTOGRAD = 1, 2


def host(name, start, stop, thread=MAIN, corr=0):
    return SimpleNamespace(name=name, device_type=DeviceType.CPU, thread=thread, id=corr,
                           time_range=SimpleNamespace(start=start, end=stop),
                           is_user_annotation=name.startswith(("repro_torch.", "portbench.")))


def device(name, start, stop, corr, annotation=False):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA, thread=0, id=corr,
                           time_range=SimpleNamespace(start=start, end=stop),
                           is_user_annotation=annotation)


def launch(name, at, corr, thread=MAIN, kernel="void elementwise_kernel", took=2.0, op="aten::add"):
    """An op on ``thread`` whose runtime call at ``at`` (us) launches
    ``kernel``, which starts 2 us later and runs ``took`` us."""
    return [host(op, at - 0.5, at + 0.6, thread), host(name, at, at + 0.5, thread, corr),
            device(kernel, at + 2, at + 2 + took, corr)]


def step_events(program: bool = True) -> list:
    """One training step: the cast on the main thread, the backward on
    autograd's (a recompute holding the mixer's conv, the cast's backward,
    two gradient adds, one launching), the optimizer on the main thread;
    one kernel whose launch the trace lacks.  ``program=False`` leaves
    out the program's spans and their device annotations."""
    ev = [host("portbench.step", 0, 200)]
    ev += launch("cudaLaunchKernel", 5, 101)
    ev += launch("cuLaunchKernel", 33, 102, AUTOGRAD, "conv_depthwise2d_forward", 3.0)
    ev += launch("cudaLaunchKernel", 45, 103, AUTOGRAD, "nvjet_tst_192x192", 4.0, "aten::mm")
    ev += launch("cudaLaunchKernel", 56, 104, AUTOGRAD, took=1.5, op="aten::_to_copy")
    ev += launch("cudaLaunchKernel", 62, 105, AUTOGRAD, took=0.5, op="aten::add_")
    ev += launch("cudaMemsetAsync", 86, 106, kernel="Memset (Device)", took=0.25, op="aten::zero_")
    ev += launch("cudaLaunchKernel", 150, 107, op="aten::random_")  # outside the step
    ev += [device("void orphan_kernel", 190, 191, 999)]
    ev += [host(S.GRAD_ADD, 61, 65, AUTOGRAD), host(S.GRAD_ADD, 66, 68, AUTOGRAD),
           host(S.GRAD_ADD, 170, 172, AUTOGRAD)]  # the last outside the step
    if program:
        ev += [host("repro_torch.train_step", 1, 99), host("repro_torch.cast", 2, 10),
               host("repro_torch.recompute", 30, 50, AUTOGRAD),
               host("repro_torch.mamba.conv", 32, 40, AUTOGRAD),
               host("repro_torch.cast.backward", 55, 60, AUTOGRAD),
               host("repro_torch.optimizer", 85, 95),
               device("repro_torch.train_step", 7, 96, 0, annotation=True),
               device("repro_torch.optimizer", 88, 89, 0, annotation=True)]
    return ev


def profile_of(events):
    return SimpleNamespace(events=lambda: events)


def test_kernels_go_to_the_spans_open_at_their_launch_on_either_thread():
    spans = S.read(profile_of(step_events()))
    assert spans["cast"] == {"count": 1, "ops": 1, "device_s": 2e-6, "self_s": 2e-6,
                             "ops_each": {"1": 1}}
    assert spans["mamba.conv"]["ops"] == 1 and spans["mamba.conv"]["self_s"] == 3e-6
    # the recompute holds the conv's launch too, but is the innermost of the mm's alone
    assert spans["recompute"]["ops"] == 2
    assert spans["recompute"]["device_s"] == pytest.approx(7e-6)
    assert spans["recompute"]["self_s"] == 4e-6
    assert spans["cast.backward"]["ops"] == 1 and spans["cast.backward"]["self_s"] == 1.5e-6
    assert spans["optimizer"]["ops"] == 1 and spans["optimizer"]["self_s"] == 0.25e-6
    # the step holds every launch from its start to its end, autograd's among them
    step = spans["train_step"]
    assert (step["count"], step["ops"], step["self_s"]) == (1, 6, 0.0)
    assert step["device_s"] == pytest.approx(11.25e-6)
    # two adds inside the step, one launching; the one after the step is not counted
    assert spans["AccumulateGrad"] == {"count": 2, "ops": 1, "device_s": 0.5e-6, "self_s": 0.0,
                                       "ops_each": {"0": 1, "1": 1}}
    assert spans["unlinked"] == {"ops": 1, "device_s": 1e-6}


def test_no_program_annotation_counts_as_a_device_op():
    ev = step_events()
    plain = [e for e in ev
             if not (e.device_type == DeviceType.CUDA and e.name.startswith("repro_torch."))]
    assert S.read(profile_of(ev)) == S.read(profile_of(plain))
    assert T.read(profile_of(ev), 1.0).class_count == T.read(profile_of(plain), 1.0).class_count
    assert sum(T.read(profile_of(ev), 1.0).class_count.values()) == 8  # 7 launched, 1 orphan
    # one the profiler did not flag is no operation of the spans either
    ev.append(device("repro_torch.prefill", 100, 180, 0))
    assert S.read(profile_of(ev)) == S.read(profile_of(plain))


def test_readers_per_step_and_none_without_spans():
    trace = SimpleNamespace(spans=S.read(profile_of(step_events())),
                            span_window={"steps": 2, "kernel_counts": {}, "traces": 1})
    r = SimpleNamespace(trace=trace)
    assert cast_ms.read(r) == pytest.approx(1e3 * (2 + 1.5 + 0.5) * 1e-6 / 2)
    assert optimizer_ms.read(r) == pytest.approx(1e3 * 0.25e-6 / 2)
    assert recompute_ms.read(r) == pytest.approx(1e3 * 7e-6 / 2)
    assert mixer_conv_ms.read(r) == pytest.approx(1e3 * 3e-6 / 2)
    assert launches.read(r) == 3.0
    # a program without the spans, or the trace module's own trace, reads nothing (never 0)
    bare = SimpleNamespace(spans=S.read(profile_of(step_events(program=False))),
                           span_window={"requests": 8})
    old = T.read(profile_of(step_events()), 1.0)
    for reader in (cast_ms, optimizer_ms, recompute_ms, mixer_conv_ms, launches):
        assert reader.read(SimpleNamespace(trace=bare)) is None
        assert reader.read(SimpleNamespace(trace=old)) is None
        assert reader.read(SimpleNamespace(trace=None)) is None


def prefill_events(program: bool) -> list:
    """A request whose device work stops twice: once while the host runs
    ``aten::gather``, once while it runs nothing under the program's
    span."""
    ev = [host("portbench.request", 0, 100)]
    ev += launch("cudaLaunchKernel", 10, 201)
    ev += [host("aten::gather", 20, 30), host("cudaLaunchKernel", 29, 29.5, MAIN, 202),
           device("void gather_kernel", 31, 32, 202)]
    ev += launch("cudaLaunchKernel", 60, 203)
    if program:
        ev += [host("repro_torch.prefill", 5, 95),
               device("repro_torch.prefill", 12, 64, 0, annotation=True)]
    return ev


def test_trace_fields_are_equal_with_and_without_program_spans():
    for events in (step_events, prefill_events):
        with_spans, without = (T.read(profile_of(events(p)), 1.0) for p in (True, False))
        for f in dataclasses.fields(T.Trace):
            if f.name != "idle_gaps":
                assert getattr(with_spans, f.name) == getattr(without, f.name), f.name
        # the same gaps, which a program span may name otherwise
        assert sum(s for _, s in with_spans.idle_gaps) == pytest.approx(
            sum(s for _, s in without.idle_gaps))


def test_gap_labels_carry_the_program_span_where_it_is_the_innermost_range():
    with_spans, without = (T.read(profile_of(prefill_events(p)), 1.0) for p in (True, False))
    assert dict(without.idle_gaps) == pytest.approx({"request/aten::gather": 17e-6,
                                                     "request/idle": 30e-6})
    assert dict(with_spans.idle_gaps) == pytest.approx({"request/aten::gather": 17e-6,
                                                        "request/repro_torch.prefill": 30e-6})
