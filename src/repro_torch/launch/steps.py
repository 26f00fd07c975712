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

Under an active mesh (``launch.mesh.cell_context`` of a ``"train"``
shape) ``params`` and the moments are this rank's shards and ``batch``
the whole global batch, whose rows the model cuts.  The step takes the
reference's two mesh branches through autograd alone: the compute-dtype
copy of the parameters, ``fsdp`` shards gathered whole, is made once a
step outside the micro-batch loop (its note c3), and its graph is kept
across the micro-batches, so each micro-batch's ``backward`` sums the
gradient over the batch axes onto this rank's shard (the gather's
backward, a reduce-scatter: its note c1; ``context.fan_out`` over the
axes that do not cut the leaf) and adds it into the float32 master's
``.grad``.  The loss's mean over the batch axes has scaled each rank's
part already.  The global norm counts each leaf once
(``adamw.global_norm``'s ``counted``) and AdamW updates the shards.

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
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import context as ctx
from repro_torch.runtime.trace import span


def param_tree(params: M.LM) -> dict:
    """The LM's leaves as a nested dict keyed by the parts of their names
    (``{"layers": {"0": {"mixer": {"wq": ...}}}, "embed": {"table": ...}}``),
    the tree AdamW runs over: its leaves are the parameters themselves."""
    return _tree_of(dict(params.named_parameters()))


def _tree_of(named: dict) -> dict:
    """A mapping of dotted parameter names as a nested dict."""
    tree: dict = {}
    for name, p in named.items():
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


def _micro_batches(batch: dict, accum: int) -> list[dict]:
    if accum == 1:
        return [batch]
    return [{k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i] for k, v in batch.items()}
            for i in range(accum)]


def _grads(cfg: ModelConfig, params: M.LM, micros: list[dict]):
    """``(gradient per parameter name, loss sum, last parts)``: the
    compute copy made once (:func:`~repro_torch.models.model.cast_for_compute`
    under autograd), then each micro-batch's ``backward`` through it,
    which adds the micro-batch's float32 gradient into the master leaves'
    ``.grad`` (summed onto this rank's shards under a mesh).  The copy's
    graph is kept until the last micro-batch; each micro-batch's own
    graph goes before the next one's forward."""
    compute = M.cast_for_compute(cfg, params)
    l_sum = None
    for i, micro in enumerate(micros):
        l, parts = M.loss_fn(cfg, compute, micro, cast=False)
        l.backward(retain_graph=i + 1 < len(micros))
        l_sum = l.detach() if l_sum is None else l_sum + l.detach()
        parts = {k: v.detach() for k, v in parts.items()}
        del l
    grads = {name: torch.zeros_like(p) if p.grad is None else p.grad
             for name, p in params.named_parameters()}
    return grads, l_sum, parts


def make_train_step(
    cfg: ModelConfig,
    *,
    accum: int = 1,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor] | None = None,
    max_grad_norm: float = 1.0,
) -> Callable:
    if lr_schedule is None:
        lr_schedule = adamw.cosine_schedule(3e-4, 200, 10_000)
    counted: dict = {}  # per mesh: which leaves this rank counts in the norm

    def train_step(params: M.LM, opt_state: adamw.AdamWState, batch: dict, step):
        with span("train_step"):
            leaves = [p for p in params.parameters() if p.requires_grad]
            for p in leaves:
                p.grad = None
            micros = _micro_batches(batch, accum)
            by_name, l_sum, parts = _grads(cfg, params, micros)
            tree = param_tree(params)
            grads = _tree_of(by_name)
            with span("optimizer"):
                if accum == 1:
                    loss = l_sum
                else:
                    with torch.no_grad():
                        adamw._map(lambda _, g: g.div_(accum), grads)
                    loss, parts = l_sum / accum, {}
                mesh = ctx.current_mesh()
                if mesh is not None and mesh not in counted:
                    counted[mesh] = _tree_of(mesh_lib.counted_leaves(cfg, params))
                gnorm = adamw.clip_by_global_norm_(grads, max_grad_norm,
                                                   counted=counted.get(mesh))
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
        with span("prefill"):
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
