"""A training cell: ``repro_torch.launch.steps.make_train_step`` on one
model and its AdamW state, fed a new batch of token rows every step.

Set-up makes the float32 weights from the seed, builds the program's
model, optimizer state and step, and drives the step through the first
``check_steps`` steps, the warm-up, whose readings the check compares
with the reference's same steps: each loss, every leaf's first clipped
gradient (from AdamW's first moment after one step) and every leaf's
change over those steps (against a host copy of the start, whose cost is
left out of ``setup_s``).  The window then runs whole steps, each ending
in a synchronise, until ``seconds`` have passed: ``train_tokens_per_s``
is every token of those steps over their time.  A traced run traces
``trace_steps`` steps instead.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from portbench import check
from portbench import traffic as T
from portbench import work as W
from portbench.cells.common import Cell, Clock, Outcome, peak_bytes, release, sync


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def run(cell: Cell) -> Outcome:
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    clock = Clock(cell.started)
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    job, vocab = tr["optimizer"], cfg["vocab_size"]
    mcfg = cell.model_config()
    lm = M.train_mode(cell.family().build(mcfg, cell.weights(lambda _: torch.float32)))
    opt = adamw.init(steps.param_tree(lm), mcfg.moment_dtype)
    schedule = adamw.cosine_schedule(job["lr"], job["warmup_steps"], job["total_steps"],
                                     job["min_ratio"])
    step = steps.make_train_step(mcfg, accum=tr["accum"], lr_schedule=schedule,
                                 max_grad_norm=job["max_grad_norm"])
    t0 = time.perf_counter()
    start = {n: p.detach().to("cpu", copy=True) for n, p in lm.named_parameters()}
    clock.exclude(t0)

    def one(j: int) -> torch.Tensor:
        nonlocal lm, opt
        with record_function("portbench.feed"):
            batch = T.train_batch(tr, cell.seed, j, vocab, dev)
        with record_function("portbench.step"):
            lm, opt, metrics = step(lm, opt, batch, j)
        return metrics["loss"]

    n_check = cell.limits["check_steps"]
    losses = []
    for j in range(n_check):
        losses.append(one(j))
        if j == 0:
            sync(dev)
            t0 = time.perf_counter()
            grad1 = {n: float(m.norm()) / (1 - job["b1"]) for n, m in _flat(opt.m).items()}
            clock.exclude(t0)
    sync(dev)
    t0 = time.perf_counter()
    change = {n: float((p.detach() - start[n].to(dev)).norm()) for n, p in lm.named_parameters()}
    del start
    losses = [float(x) for x in losses]
    clock.exclude(t0)
    setup_s = clock.setup_s()

    tokens_per_step = tr["micro_batch"] * tr["accum"] * tr["seq_len"]
    trace = work = None
    window = []
    if cell.trace:
        from portbench.trace import trace_window

        def body(steps: int) -> dict:
            for _ in range(steps):
                window.append(one(n_check + len(window)))
            return {"steps": steps}

        trace = trace_window(lambda: body(tr["trace_steps"]), lambda: body(1))
        per_step = W.train_work(cfg, tr["micro_batch"], tr["seq_len"], tr["accum"])
        work = {k: v * tr["trace_steps"] for k, v in per_step.items()}
        metrics = {}
    else:
        j = n_check
        t_start = time.perf_counter()
        while True:
            window.append(one(j))
            j += 1
            sync(dev)
            now = time.perf_counter()
            if now - t_start >= cell.seconds:
                break
        metrics = {"train_tokens_per_s": len(window) * tokens_per_step / (now - t_start)}
    metrics["setup_s"] = setup_s
    attempted = len(window)
    failed = int((~torch.isfinite(torch.stack(window))).sum())
    peak = peak_bytes(dev)
    del lm, opt, step, window
    release(dev)

    from portbench.reference import common as C
    from portbench.reference import train as RT

    C.full_float32()
    batches = [T.train_batch(tr, cell.seed, j, vocab, dev) for j in range(n_check)]
    t0 = time.perf_counter()
    ref = RT.run(cell.reference(), cfg, cell.weights(lambda _: torch.float32), batches, job,
                 tr["accum"])
    numbers = check.train_numbers({"losses": losses, "grad1": grad1, "change": change}, ref)
    return Outcome(metrics, attempted, failed, numbers, peak, trace, work,
                   notes={"losses": losses, "reference_losses": ref["losses"],
                          "reference_s": time.perf_counter() - t0})
