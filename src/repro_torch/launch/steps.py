"""Step functions (port of ``repro.launch.steps``): training with gradient
accumulation, and serving.

``make_train_step(cfg)`` returns ``(params, opt_state, batch, step) ->
(params, opt_state, metrics)``: the reference's value-and-grad of
``loss_fn`` over ``accum`` micro-batches (gradients accumulated in
float32), clipping by the global norm, the learning-rate schedule and one
AdamW step.  ``params`` is a trainable :class:`~repro_torch.models.model.LM`
(``model.train_mode``) and ``opt_state`` an ``adamw.AdamWState`` over
:func:`param_tree`; both are updated in place and returned.  Its attention
and mamba layers run K1 and K2 forward and backward as kernels on a card.
The reference's mesh-only branches (the gradient's sharding pin and the
hoisted parameter gather) wait for training across ranks, ROADMAP §1
P14b; under a mesh the forward refuses a gradient.

``make_prefill_step(cfg)`` returns ``(params, batch) -> last-position
logits``; ``make_decode_step(cfg)`` returns ``(params, cache, tokens,
pos) -> (next_token, logits, cache)`` with greedy argmax; with
``cast=False`` its params must already be as ``cast_for_compute`` returns
them (a decode loop casts once).  Both run without autograd, and under
an active mesh (``launch.mesh.cell_context``) on this rank's shards of
the parameters and cache, with whole batches in and out.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import context as ctx


def param_tree(params: M.LM) -> dict:
    """The LM's leaves as a nested dict keyed by the parts of their names
    (``{"layers": {"0": {"mixer": {"wq": ...}}}, "embed": {"table": ...}}``),
    the tree AdamW runs over: its leaves are the parameters themselves."""
    tree: dict = {}
    for name, p in params.named_parameters():
        *parents, leaf = name.split(".")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = p
    return tree


def auto_accum(cfg: ModelConfig, global_batch: int, *, target_micro: int = 2) -> int:
    """The accumulation factor that gives each device about
    ``target_micro`` sequences a micro-batch, ``dp`` the batch axes' ranks
    of the active mesh (1 without one)."""
    dp = ctx.axis_size("batch")
    local = max(1, global_batch // dp)
    accum = max(1, local // target_micro)
    while global_batch % accum or (global_batch // accum) % dp:
        accum -= 1
    return max(1, accum)


def make_train_step(
    cfg: ModelConfig,
    *,
    accum: int = 1,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor] | None = None,
    max_grad_norm: float = 1.0,
) -> Callable:
    if lr_schedule is None:
        lr_schedule = adamw.cosine_schedule(3e-4, 200, 10_000)

    def train_step(params: M.LM, opt_state: adamw.AdamWState, batch: dict, step):
        leaves = [p for p in params.parameters() if p.requires_grad]
        for p in leaves:
            p.grad = None
        micros = [batch] if accum == 1 else [
            {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i] for k, v in batch.items()}
            for i in range(accum)
        ]
        l_sum = None
        for micro in micros:
            # backward adds each micro-batch's float32 gradient into .grad
            l, parts = M.loss_fn(cfg, params, micro)
            l.backward()
            l_sum = l.detach() if l_sum is None else l_sum + l.detach()
        tree = param_tree(params)
        grads = adamw._map(
            lambda _, p: torch.zeros_like(p) if p.grad is None else p.grad, tree
        )
        if accum == 1:
            loss = l_sum
            parts = {k: v.detach() for k, v in parts.items()}
        else:
            with torch.no_grad():
                adamw._map(lambda _, g: g.div_(accum), grads)
            loss, parts = l_sum / accum, {}
        gnorm = adamw.clip_by_global_norm_(grads, max_grad_norm)
        lr = lr_schedule(torch.as_tensor(step))
        opt_state = adamw.update_(grads, opt_state, tree, lr=lr)
        for p in leaves:
            p.grad = None
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, **parts}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, cast: bool = True) -> Callable:
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = M.decode_step(cfg, params, cache, tokens, pos, cast=cast)
        # torch.argmax returns the first maximal index, as jnp.argmax does
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return serve_step
