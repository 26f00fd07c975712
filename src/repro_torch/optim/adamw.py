"""AdamW over nested dicts of tensors, with schedules and global-norm
clipping (port of ``repro.optim.adamw``).

Plain functions over parameter trees (dicts, lists or tuples of tensors),
so the placement search, the calibration fit and a training step share
them.  A language model's tree is ``launch.steps.param_tree``: its leaves
keyed by the parts of their names, so :func:`_decay_mask` reads the
reference's leaf names (``wq``, ``norm1``, ``dt_bias``, ...).  Where the
reference returns new trees, :func:`update_` and
:func:`clip_by_global_norm_` write into the ones they are given.  The arithmetic
follows the reference's float32 order: the bias corrections
``1 - b ** step`` in float32, then ``(m / c1) / (sqrt(v / c2) + eps)``,
decay added to the step and ``p - lr * step`` last.  ``torch.optim.AdamW``
decays ``p`` before its step, which rounds differently, so it is not used.

Under a mesh the trees hold this rank's shards: the update stays
elementwise, and :func:`global_norm` adds each leaf's sum of squares over
the mesh, counting a leaf that several ranks hold once (``counted``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.parallel import context as ctx

_F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any  # tree like params
    v: Any  # tree like params


def _map(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a nested dict / list / tuple;
    ``path`` holds the keys (dict keys, ``[i]`` for sequence items).  Dict
    keys are visited sorted, as JAX flattens a tree, so reductions over
    the leaves sum in the reference's order."""
    if isinstance(tree, dict):
        return {
            k: _map(fn, tree[k], *(r[k] for r in rest), path=path + (k,))
            for k in sorted(tree)
        }
    if isinstance(tree, (list, tuple)):
        out = [
            _map(fn, t, *(r[i] for r in rest), path=path + (f"[{i}]",))
            for i, t in enumerate(tree)
        ]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(path, tree, *rest)


def _leaves(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map(lambda _, x: out.append(x), tree)
    return out


def init(params: Any, moment_dtype: str = "float32") -> AdamWState:
    """Zero moments shaped like ``params`` (floating leaves in
    ``moment_dtype``, others in their own dtype) and step 0."""
    dt = getattr(torch, moment_dtype)

    def zeros(_, p):
        return torch.zeros(p.shape, dtype=dt if p.is_floating_point() else p.dtype,
                           device=p.device)

    first = _leaves(params)
    dev = first[0].device if first else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=_map(zeros, params),
        v=_map(zeros, params),
    )


def global_norm(tree: Any, *, counted: Any = None) -> torch.Tensor:
    """The L2 norm over every leaf, in float32.  ``counted``, a tree of
    bools like ``tree``, makes it the norm of leaves that lie in shards
    over the active mesh: each leaf's sum of squares is added over the
    mesh, from the ranks where ``counted`` is true (one of the ranks
    holding the same indices), before the sum over the leaves."""
    leaves = _leaves(tree)
    marks = [True] * len(leaves) if counted is None else _leaves(counted)
    sums = torch.stack([torch.sum(torch.square(x.to(_F32))) if mark
                        else torch.zeros((), dtype=_F32, device=x.device)
                        for x, mark in zip(leaves, marks)])
    if counted is not None and ctx.current_mesh() is not None:
        sums = ctx.psum(sums, ctx.current_mesh().axis_names)
    return torch.sqrt(torch.sum(sums))


@torch.no_grad()
def clip_by_global_norm_(grads: Any, max_norm: float, *, counted: Any = None) -> torch.Tensor:
    """Scale each leaf of ``grads`` in place so their global norm
    (:func:`global_norm`, ``counted`` as there) is at most ``max_norm``;
    returns the norm before scaling."""
    norm = global_norm(grads, counted=counted)
    one = torch.ones((), dtype=_F32, device=norm.device)
    scale = torch.minimum(one, max_norm / torch.maximum(norm, torch.full_like(norm, 1e-9)))
    _map(lambda _, g: g.copy_((g.to(_F32) * scale).to(g.dtype)), grads)
    return norm


def _decay_mask(path) -> bool:
    """Weight decay applies to matrices only (not norms/biases/1-D),
    keyed on the leaf's name."""
    name = str(path[-1])
    return "norm" not in name and name not in ("dt_bias", "conv_b", "D", "A_log")


@torch.no_grad()
def update_(
    grads: Any,
    state: AdamWState,
    params: Any,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> AdamWState:
    """One AdamW step in place: the new parameters and moments are written
    into ``params``' and the state's tensors one leaf at a time, so no
    second copy of parameters, gradients and moments is held; returns the
    state with its step advanced (its ``m`` and ``v`` trees are the ones
    passed in)."""
    step = state.step + 1
    s32 = step.to(_F32)
    # torch.full, not torch.tensor: a host scalar copied to the card would
    # synchronise every step
    c1 = 1.0 - torch.pow(torch.full((), b1, dtype=_F32, device=s32.device), s32)
    c2 = 1.0 - torch.pow(torch.full((), b2, dtype=_F32, device=s32.device), s32)

    def write(path, p, g, m, v):
        if not p.is_floating_point():
            return
        g32 = g.to(_F32)
        m32 = m.to(_F32) * b1 + g32 * (1 - b1)
        v32 = v.to(_F32) * b2 + g32 * g32 * (1 - b2)
        u = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        if _decay_mask(path):
            u = u + weight_decay * p.to(_F32)
        p.copy_(p.to(_F32) - lr * u)
        m.copy_(m32)
        v.copy_(v32)

    _map(write, params, grads, state.m, state.v)
    return AdamWState(step=step, m=state.m, v=state.v)


def cosine_schedule(
    base_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``base_lr``, then a cosine decay to
    ``min_ratio * base_lr`` at ``total_steps``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(step).to(_F32)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp(
            (s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup_steps, warm, cos)

    return lr
