"""A prefill cell of a model whose MoE routes each token (``hybrid``):
the set-up and the window of ``cells/prefill.py``, and a check that
holds the reference to the program's expert choices.

After the window, before the program is freed, the sampled requests are
served again with the program recording its expert choices
(``repro_torch.models.moe.choice_record``); a replay whose logits differ
from the window's in any bit counts every checked request as failed.
The float32 reference then runs each sampled request with those choices
forced (``reference/hybrid.py::routing``), so a choice that a last-bit
difference flips near a tie moves neither side: ``logit_err`` and
``greedy_gap`` are ``check.prefill_numbers``'s, and ``route_margin`` is
the widest gap in the reference's float32 router logits between its own
2nd and 3rd choice over the (token, layer) pairs where its own top 2
differs from the program's (a sound program differs only near ties).

A traced run's body returns ``expert_least_s`` beside ``requests``: the
experts' least time over the traced requests (``families/hybrid.py::
expert_work``: the operations of k choices a token, every expert's
weights read once), which ``metrics/moe_roofline_pct.py`` reads.

    python3 -m portbench.cells.prefill_routed --workload NAME --seeds 1 2 3

(from the root, with ``src`` on the path, on a card) prints the readings
the limits are set from that a run does not make, one JSON line a seed:
the float8 control (the reference with its products' operands in float8
e4m3 in the program's place, its own choices forced on the float32
reference) and the fault of a router taken in bf16 (the float32
reference with its router's operands and logits rounded to bf16).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import check
from portbench import traffic as T
from portbench import work as W
from portbench.cells.common import Cell, Clock, Outcome, peak_bytes, release, sync
from portbench.cells.prefill import sample
from portbench.weights import serve_dtype


def reference_numbers(cell: Cell, held: dict, requests: list[tuple[int, int]],
                      served: dict, choices: dict) -> dict[str, float]:
    """``requests``: (index, length); ``served[i]`` the last-position
    logits to judge, ``choices[i]`` the expert choices that made them (one
    (T, k) tensor an MoE layer).  The float32 reference runs each request
    with those choices forced."""
    from portbench.reference import common as C

    ref, cfg = cell.reference(), cell.cfg
    pairs, margin = [], 0.0
    with torch.no_grad():
        for i, length in requests:
            tokens = T.prompt(cell.seed, i, length, cfg["vocab_size"], cell.device)
            with ref.routing(forced=choices[i]) as routes:
                h = C.hidden(ref, cfg, held, tokens, "float32")[:, -1]
            pairs.append((served[i], C.logits(cfg, held, h, "float32")[0]))
            margin = max(margin, ref.route_margin(routes.logits, choices[i],
                                                  cfg["num_experts_per_tok"]))
    return dict(check.prefill_numbers(pairs), route_margin=margin)


def run(cell: Cell) -> Outcome:
    from repro_torch.configs.base import torch_dtype
    from repro_torch.launch import steps
    from repro_torch.models import moe

    clock = Clock(cell.started)
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    vocab = cfg["vocab_size"]
    mcfg = cell.model_config()
    compute = torch_dtype(mcfg.compute_dtype)
    held = cell.weights(lambda name: serve_dtype(cell.family(), name, compute))
    lm = cell.family().build(mcfg, held)
    step = steps.make_prefill_step(mcfg)
    for length in sorted(set(T.deck(tr))):
        for r in range(2):
            step(lm, {"tokens": T.tokens(cell.seed, f"warm{length}.{r}", (1, length), vocab, dev)})
    sync(dev)
    setup_s = clock.setup_s()

    lengths = T.Lengths(tr, cell.seed)
    served, times = [], []

    def request(i: int) -> None:
        with record_function("portbench.feed"):
            tokens = T.prompt(cell.seed, i, lengths[i], vocab, dev)
        t0 = time.perf_counter()
        with record_function("portbench.request"):
            logits = step(lm, {"tokens": tokens})
            sync(dev)
        times.append(time.perf_counter() - t0)
        served.append(logits[0, :vocab])

    trace = work = None
    if cell.trace:
        from portbench.trace import trace_window

        n = tr["trace_decks"] * len(T.deck(tr))

        def body(count: int) -> dict:
            first = len(served)
            for i in range(first, first + count):
                request(i)
            return {"requests": count, "expert_least_s": sum(
                experts_least_s(cell, lengths[i]) for i in range(first, first + count))}

        trace = trace_window(lambda: body(n), lambda: body(len(T.deck(tr))))
        done = [lengths[i] for i in range(len(served) - n, len(served))]
        work = {"gemm": [], "k1": [], "k2": []}
        for length in done:
            for k, v in W.prefill_work(cfg, 1, length).items():
                work[k] += v
        metrics = {}
    else:
        t_start = time.perf_counter()
        i = 0
        while True:
            request(i)
            i += 1
            if time.perf_counter() - t_start >= cell.seconds:
                break
        window_s = time.perf_counter() - t_start
        metrics = {
            "prefill_tokens_per_s": sum(lengths[j] for j in range(i)) / window_s,
            "prefill_ms_p95": 1e3 * float(np.percentile(times, 95)),
        }
    metrics["setup_s"] = setup_s
    attempted = len(served)
    failed = sum(not bool(torch.isfinite(s).all()) for s in served)
    peak = peak_bytes(dev)

    picked = sample([lengths[i] for i in range(attempted)], cell.limits["check_requests"],
                    cell.seed)
    choices, replay_equal = {}, True
    for i in picked:
        with moe.choice_record() as record:
            again = step(lm, {"tokens": T.prompt(cell.seed, i, lengths[i], vocab, dev)})
        choices[i] = record
        replay_equal &= bool(torch.equal(again[0, :vocab], served[i]))
    if not replay_equal:
        failed += len(picked)
    del lm, step
    release(dev)

    from portbench.reference import common as C

    C.full_float32()
    t0 = time.perf_counter()
    numbers = reference_numbers(cell, held, [(i, lengths[i]) for i in picked],
                                dict(enumerate(served)), choices)
    return Outcome(metrics, attempted, failed, numbers, peak, trace, work,
                   notes={"checked": [lengths[i] for i in picked],
                          "expert_rows": expert_rows(choices, cfg["num_experts"]),
                          "replay_bit_equal": replay_equal,
                          "reference_s": time.perf_counter() - t0,
                          "requests": attempted})


def expert_rows(choices: dict, experts: int) -> list[list[int]]:
    """Per checked request, the fewest and the most rows any expert of
    any MoE layer took."""
    out = []
    for record in choices.values():
        counts = torch.stack([torch.bincount(c.reshape(-1), minlength=experts) for c in record])
        out.append([int(counts.min()), int(counts.max())])
    return out


def experts_least_s(cell: Cell, length: int) -> float:
    """The least time of every MoE layer's experts over one prompt."""
    ref, cfg = cell.reference(), cell.cfg
    layers = sum(ref.ffn_kind(cfg, i) == "moe" for i in range(cfg["n_layers"]))
    return layers * W.least_s(cell.family().expert_work(cfg, length))


def control_readings(cell: Cell, picked_from: int = 16) -> dict:
    """The float8 control and the bf16-router fault against the float32
    reference, each judged as a run judges the program, at the last
    position of a sample of the first ``picked_from`` requests of the
    seed's deal, drawn as a run draws."""
    from portbench.reference import common as C

    C.full_float32()
    cfg, dev, ref = cell.cfg, cell.device, cell.reference()
    held = cell.weights(lambda name: serve_dtype(cell.family(), name, torch.bfloat16))
    lengths = T.Lengths(cell.traffic, cell.seed)
    picked = sample([lengths[i] for i in range(picked_from)], cell.limits["check_requests"],
                    cell.seed)
    out = {}
    for label, precision, router in (("fp8", "fp8", "float32"),
                                     ("bf16_router", "float32", "bf16")):
        served, choices = {}, {}
        with torch.no_grad():
            for i in picked:
                tokens = T.prompt(cell.seed, i, lengths[i], cfg["vocab_size"], dev)
                with ref.routing(router=router) as routes:
                    h = C.hidden(ref, cfg, held, tokens, precision)[:, -1]
                served[i] = C.logits(cfg, held, h, precision)[0]
                choices[i] = routes.chosen
        out[label] = reference_numbers(cell, held, [(i, lengths[i]) for i in picked], served,
                                       choices)
    out["checked"] = [lengths[i] for i in picked]
    return out


def main() -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    parser = argparse.ArgumentParser(description="control readings of a routed prefill cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    sys.path[:0] = [str(root / "src"), str(root)]
    from portbench import controls, harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = harness.make_cell(spec, args.workload, seed, 0.0, False, "cuda", t0)
        readings = control_readings(cell)
        print(json.dumps({"workload": args.workload, "seed": seed, **readings,
                          "correct": controls.verdicts(readings, cell.limits),
                          "seconds": time.perf_counter() - t0}), flush=True)
        release("cuda")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
