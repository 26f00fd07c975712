"""The readings the limits are set from that a benchmark run does not
make: the control (the reference put in the program's place, its
products in float8 e4m3, the precision below the configuration's bf16)
and, for a training cell, the reference with half of each batch left out
(the mean taken over the rest), each against the float32 reference, at
the cell's own size, on the card:

    python3 portbench/controls.py --workload NAME --seeds 1 2 3

Prints one JSON line a seed: each reading's numbers and, under
``correct``, its verdict against the cell's limits
(``portbench/limits/<cell>.json``, as a run applies them), which has to be
false for every control and fault.  The benchmark's runs never run this;
``portbench/tests/test_portbench_controls.py`` keeps it at a size a test
run can hold.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def prefill_readings(cell, picked_from: int = 16) -> dict:
    """fp8 against float32 at the last position of a sample of the first
    ``picked_from`` requests of the seed's deal, drawn as a run draws."""
    import torch

    from portbench import check
    from portbench import traffic as T
    from portbench.cells.prefill import sample
    from portbench.reference import common as C
    from portbench.weights import serve_dtype

    C.full_float32()
    cfg, dev = cell.cfg, cell.device
    held = cell.weights(lambda name: serve_dtype(cell.family(), name, torch.bfloat16))
    lengths = T.Lengths(cell.traffic, cell.seed)
    picked = sample([lengths[i] for i in range(picked_from)], cell.limits["check_requests"],
                    cell.seed)
    ref = cell.reference()
    pairs = []
    with torch.no_grad():
        for i in picked:
            tokens = T.prompt(cell.seed, i, lengths[i], cfg["vocab_size"], dev)
            got = {p: C.logits(cfg, held, C.hidden(ref, cfg, held, tokens, p)[:, -1], p)[0]
                   for p in ("fp8", "float32")}
            pairs.append((got["fp8"], got["float32"]))
    return {"fp8": check.prefill_numbers(pairs), "checked": [lengths[i] for i in picked]}


def train_readings(cell) -> dict:
    """The float32 reference's first steps, and the control's and the
    half-batch fault's against them."""
    import torch

    from portbench import check
    from portbench import traffic as T
    from portbench.reference import common as C
    from portbench.reference import train as RT

    C.full_float32()
    tr, dev = cell.traffic, cell.device
    batches = [T.train_batch(tr, cell.seed, j, cell.cfg["vocab_size"], dev)
               for j in range(cell.limits["check_steps"])]
    half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]

    def steps(bs, precision):
        return RT.run(cell.reference(), cell.cfg, cell.weights(lambda _: torch.float32), bs,
                      tr["optimizer"], tr["accum"], precision)

    want = steps(batches, "float32")
    out = {"reference_losses": want["losses"]}
    for label, bs, precision in (("fp8", batches, "fp8"), ("half_batch", half, "float32")):
        out[label] = check.train_numbers(steps(bs, precision), want)
    return out


def verdicts(readings: dict, limits: dict) -> dict[str, bool]:
    """``{label: correct}`` of every control and fault in ``readings``
    (those whose value is a dict of numbers), judged as a run is."""
    from portbench import check

    return {label: check.verdict(numbers, limits)[0] for label, numbers in readings.items()
            if isinstance(numbers, dict)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = harness.make_cell(spec, args.workload, seed, 0.0, False, "cuda", t0)
        kind = cell.traffic["kind"]
        readings = train_readings(cell) if kind == "train" else prefill_readings(cell)
        print(json.dumps({"workload": args.workload, "seed": seed, **readings,
                          "correct": verdicts(readings, cell.limits),
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
