"""The benchmark of the PyTorch/CUDA port, driven by ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration (``configs`` entry,
whose ``file`` holds the model's numbers) and a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``kind`` picks
``portbench/cells/<kind>.py``); its limits are
``portbench/limits/<cell>.json``.  A per-layer metric ``<base>.<split>``
is read by ``portbench/metrics/<base>.py``.  So a cell or a metric is
added by adding files and entries.

``portbench/run.py`` runs one cell once and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` (and ``breakdown`` when traced), then
``checks``: each number compared, with its limit, which also end
standard error.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from portbench import check
from portbench import traffic as T
from portbench.cells.common import Cell, Outcome

ROOT = Path(__file__).resolve().parents[1]
# top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def entry(items: list[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, workload: str) -> tuple[list[dict], list[dict]]:
    """The cell's end-to-end metrics (those without a list report in every
    cell) and the per-layer metrics that list it (each lists its cells)."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    return e2e, [m for m in spec["per_layer"] if workload in m["workloads"]]


def read_metric(name: str, outcome: Outcome):
    reader = importlib.import_module(f"portbench.metrics.{name.split('.')[0]}")
    return reader.read(outcome)


def make_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
              started: float) -> Cell:
    w = entry(spec["workloads"], workload, "workload")
    c = entry(spec["configs"], w["config"], "configuration")
    cfg = json.loads((ROOT / c["file"]).read_text())
    return Cell(workload, cfg, T.load(w["traffic"]), check.load_limits(workload), seed, seconds,
                trace, device, started)


def run_cell(cell: Cell) -> Outcome:
    kind = importlib.import_module(f"portbench.cells.{cell.traffic['kind']}")
    return kind.run(cell)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def nvidia_smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def result_line(spec: dict, cell: Cell, out: Outcome) -> tuple[dict, list[str]]:
    """The result's JSON object, and the earlier lines to print."""
    e2e, layer = cell_metrics(spec, cell.workload)
    notes = [json.dumps({"notes": out.notes, "numbers": out.numbers})]
    if cell.trace:
        values = {m["name"]: read_metric(m["name"], out) for m in layer}
        units = {m["name"]: m["unit"] for m in layer}
        tr = out.trace
        notes.append(json.dumps({"kernel_names": {
            c: {n: v for n, v in sorted(names.items(), key=lambda kv: -kv[1][1])}
            for c, names in tr.names.items()}}))
        from portbench import work as W

        notes.append(json.dumps({"roofline": {
            c: {"least_s": W.least_s(ws), "bound": W.bound_of(ws), "device_s": tr.class_s[c]}
            for c, ws in out.work.items() if ws}, "window": tr.info}))
    else:
        values = {m["name"]: out.metrics.get(m["name"]) for m in e2e}
        units = {m["name"]: m["unit"] for m in e2e}
    ok, checks = check.verdict(out.numbers, cell.limits)
    device = {"platform": "gpu" if torch.device(cell.device).type == "cuda" else cell.device,
              "kind": torch.cuda.get_device_name(0) if torch.device(cell.device).type == "cuda"
              else cell.device,
              "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    result = {
        "correct": bool(ok and out.failed == 0),
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": {n: {"value": v, "unit": units[n]} for n, v in values.items() if v is not None},
        "device": device,
    }
    if cell.trace:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.device_ops,
                               "idle_gaps": out.trace.idle_gaps}
    result["checks"] = checks
    return result, notes
