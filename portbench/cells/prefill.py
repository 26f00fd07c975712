"""A prefill cell: ``repro_torch.launch.steps.make_prefill_step`` serving
one client in a closed loop, one prompt a request, bf16 weights held as
a server holds them.

Set-up makes the weights from the seed, builds the program's model and
runs every prompt length of the mix twice.  The window sends request
after request, each timed from the call to its logits being ready on the
card (synchronised), until ``seconds`` have passed:
``prefill_tokens_per_s`` is every prompt token of the window's requests
over the window's time, ``prefill_ms_p95`` the 95th percentile of all its
requests' times.  A traced run traces ``trace_decks`` decks of requests
instead.  Every request's last-position logits are kept; once the window
has closed and the program is freed, a sample drawn from the seed, the
longest request in it, is run through the reference.
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
from portbench.weights import serve_dtype


def sample(lengths: list[int], k: int, seed: int) -> list[int]:
    """``k`` of the finished requests, drawn from the seed: the first of
    the longest, and others at random."""
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    rng = np.random.default_rng(T.derive(seed, "check"))
    picked = rng.choice(rest, size=min(k - 1, len(rest)), replace=False).tolist()
    return [longest] + sorted(picked)


def run(cell: Cell) -> Outcome:
    from repro_torch.configs.base import torch_dtype
    from repro_torch.launch import steps

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
            return {"requests": count}

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
    del lm, step
    release(dev)

    from portbench.reference import common as C

    C.full_float32()
    ref = cell.reference()
    picked = sample([lengths[i] for i in range(attempted)], cell.limits["check_requests"],
                    cell.seed)
    t0 = time.perf_counter()
    pairs = []
    with torch.no_grad():
        for i in picked:
            tokens = T.prompt(cell.seed, i, lengths[i], vocab, dev)
            h = C.hidden(ref, cfg, held, tokens, "float32")[:, -1]
            pairs.append((served[i], C.logits(cfg, held, h, "float32")[0]))
    numbers = check.prefill_numbers(pairs)
    return Outcome(metrics, attempted, failed, numbers, peak, trace, work,
                   notes={"checked": [lengths[i] for i in picked],
                          "reference_s": time.perf_counter() - t0,
                          "requests": attempted})
