"""The reference training steps: the loss over ``accum`` micro-batches in
float32, the gradient clipped by its global norm, a cosine learning rate
and AdamW (decoupled weight decay on matrices), written from their
formulas.  Returns what the check compares: each step's loss, each leaf's
norm of the first (clipped) gradient, and each leaf's norm of the change
of its parameters over the steps."""

from __future__ import annotations

import math

import torch

from portbench.reference import common as C

def decays(model, name: str) -> bool:
    """Whether AdamW decays leaf ``name``: every leaf but the norm scales
    and those the family's reference model (its module) names."""
    leaf = name.rsplit(".", 1)[-1]
    return "norm" not in leaf and leaf not in model.NO_DECAY


def learning_rate(job: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``min_ratio * lr`` at ``total_steps``."""
    warm = step / max(job["warmup_steps"], 1)
    prog = min(max((step - job["warmup_steps"]) / max(job["total_steps"] - job["warmup_steps"], 1),
                   0.0), 1.0)
    cos = job["min_ratio"] + (1 - job["min_ratio"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return job["lr"] * (warm if step < job["warmup_steps"] else cos)


def run(model, cfg: dict, w: dict, batches: list[dict], job: dict, accum: int,
        precision: str = "float32") -> dict:
    """``len(batches)`` steps from the float32 leaves ``w`` (updated in
    place)."""
    for p in w.values():
        p.requires_grad_(True)
    start = {n: p.detach().clone() for n, p in w.items()}
    m = {n: torch.zeros_like(p) for n, p in w.items()}
    v = {n: torch.zeros_like(p) for n, p in w.items()}
    losses, grad1 = [], None
    for s, batch in enumerate(batches):
        total = 0.0
        rows = batch["tokens"].shape[0] // accum
        for a in range(accum):
            cut = slice(a * rows, (a + 1) * rows)
            h = C.hidden(model, cfg, w, batch["tokens"][cut], precision, remat=True)
            loss = C.loss(cfg, w, h, batch["labels"][cut], precision, job["z_loss"])
            (loss / accum).backward()
            total += float(loss.detach())
            del h, loss
        losses.append(total / accum)
        with torch.no_grad():
            g = {n: p.grad for n, p in w.items()}
            norm = math.sqrt(sum(float(t.double().square().sum()) for t in g.values()))
            scale = min(1.0, job["max_grad_norm"] / max(norm, 1e-9))
            for t in g.values():
                t.mul_(scale)
            if s == 0:
                grad1 = {n: float(t.norm()) for n, t in g.items()}
            lr = learning_rate(job, s)
            c1, c2 = 1 - job["b1"] ** (s + 1), 1 - job["b2"] ** (s + 1)
            for n, p in w.items():
                m[n].mul_(job["b1"]).add_(g[n], alpha=1 - job["b1"])
                v[n].mul_(job["b2"]).addcmul_(g[n], g[n], value=1 - job["b2"])
                u = (m[n] / c1) / (torch.sqrt(v[n] / c2) + job["eps"])
                if decays(model, n):
                    u += job["weight_decay"] * p
                p.sub_(lr * u)
                p.grad = None
    with torch.no_grad():
        change = {n: float((p - start[n]).norm()) for n, p in w.items()}
    return {"losses": losses, "grad1": grad1, "change": change}
