"""``BENCHMARK.json`` and the files the harness finds by name."""

from __future__ import annotations

import importlib
import json
import math
import re
from pathlib import Path

import pytest

from portbench import check, harness
from portbench import traffic as T

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("d_model", "d_ff", "n_heads", "n_kv_heads", "d_head", "ssm_state", "ssm_expand",
          "dt_rank", "sliding_window")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"][1] == "portbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for e in SPEC["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25


def test_every_cell_reports_what_its_metrics_move():
    names = {w["name"] for w in SPEC["workloads"]}
    for w in names:
        e2e, layer = harness.cell_metrics(SPEC, w)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in SPEC["per_layer"]:
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            assert w in names
            assert m["moves"] in {e["name"] for e in harness.cell_metrics(SPEC, w)[0]}


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_configs_load(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert not set(entry["reduced"]) & set(WIDTHS)
    fam = importlib.import_module(f"portbench.families.{cfg['family']}")
    ref = importlib.import_module(f"portbench.reference.{cfg['family']}")
    for name in ("FLOAT32_SERVED", "layout", "products", "prefill_kernels", "train_kernels",
                 "build"):
        assert hasattr(fam, name), name
    assert callable(ref.layer) and isinstance(ref.NO_DECAY, tuple)
    from portbench.cells.common import model_config

    count = sum(math.prod(shape) for _, shape, _ in fam.layout(cfg))
    assert count == cfg["parameters"]
    model_config(cfg)  # every field the program knows


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_cells_load(entry):
    traffic = T.load(entry["traffic"])
    importlib.import_module(f"portbench.cells.{traffic['kind']}")
    limits = check.load_limits(entry["name"])
    for number in limits["numbers"].values():
        assert number["limit"] > 0


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_limits_lie_between_their_readings(entry):
    """Every limit lies above the sound runs' largest reading and below the
    least that the control or a fault gave; a run that reads the upper
    reading on any one number is judged not correct, one that reads every
    lower reading correct."""
    from portbench import controls

    limits = check.load_limits(entry["name"])
    numbers = limits["numbers"]
    for name, n in numbers.items():
        assert n["lower"] < n["limit"] < n["upper"], name
    lower = {name: n["lower"] for name, n in numbers.items()}
    assert check.verdict(lower, limits)[0]
    for name, n in numbers.items():
        reading = dict(lower, **{name: n["upper"]})
        assert controls.verdicts({"control": reading, "checked": [1]}, limits) == {"control": False}


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_load(metric):
    reader = importlib.import_module(f"portbench.metrics.{metric['name'].split('.')[0]}")
    assert callable(reader.read)
