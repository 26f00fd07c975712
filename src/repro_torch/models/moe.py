"""Mixture-of-Experts FFN (port of ``repro.models.moe``): the
single-device dispatch and the reference's expert-parallel paths over a
mesh.

Routing is the reference's: float32 router logits, softmax, top-k with
ties going to the lower expert index, the top-k probabilities
renormalised, a Switch-style balance loss; each expert keeps its first
``C`` (capacity) selected tokens in token order and drops the rest.  The
reference dispatches with a Python loop over the experts (a dozen ops
each); here one ``cumsum`` over the tokens gives every expert's slots at
once, one gather fills an ``(E, C+1, D)`` buffer (row ``C`` is the
overflow bin, always zero), three batched products compute every
expert, and one gather brings the outputs back, combined in the compute
dtype as the reference does.  The token -> (expert, slot) assignment and
the keep mask equal the reference's.

A config may depart from the reference's routing as AI21-Jamba2-Mini's
``JambaSparseMoeBlock`` does: ``moe_renormalize=False`` keeps the top-k
probabilities as the softmax gave them, and ``moe_dropless=True`` drops
nothing (:func:`_dropless`): the (token, choice) pairs are sorted by
expert, so each expert's rows are contiguous, three grouped products
(``torch._grouped_mm``, the offsets kept on the device, so no host sync)
compute every expert over its own rows, and each token's pairs are
combined in the order of its choices, so the result is deterministic.
The dropless layer runs on one device; the mesh paths refuse it.  The
spans ``moe.route``, ``moe.experts`` and ``moe.combine`` cover the
one-device layer's three parts.

Under a mesh (:mod:`repro_torch.parallel.context`) the expert rows lie
over ``expert`` (``model``); where experts are fewer than its ranks, each
is split along ``d_ff`` into ``moe_factor`` rows whose partial outputs
the combine adds.  Their ``d_model`` dim may lie over ``efsdp``.  As in
the reference, ``moe_apply`` takes one of three paths:

* gather (``moe_ffn``): every model rank routes its rows' tokens,
  computes its own experts (``efsdp`` shards gathered first) and the
  partial outputs are added over ``model``;
* no-gather decode (``decode`` with ``efsdp`` shards): the rows are
  gathered over the ``efsdp`` axes, each rank contracts its ``d_model``
  slice of the buffers, the two ``(C+1, F)`` partials are added over
  ``efsdp`` before ``silu`` and the outputs gathered back;
* all-to-all (``moe_ffn_a2a``, ``moe_impl="a2a"`` outside decode): each
  model rank routes a slice of the sequence, sends each token with its
  gates to the ranks owning its experts (capacity ``c_send`` a
  destination), dispatches what it receives at capacity ``c2`` and sends
  the outputs back.

Capacities are taken from the tokens a rank routes, as in the reference,
so a mesh drops other tokens than one device does.  In training the
tokens and the router enter through ``context.fan_out`` over ``expert``
(each rank combines its own experts' outputs, or routes its own slice of
the sequence), so their gradients add the ranks' parts, and the
``efsdp`` weight gathers sum their gradients over the ranks before each
takes its block.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import weight
from repro_torch.parallel import context as ctx
from repro_torch.runtime.trace import span


class MoE(nn.Module):
    """One MoE FFN's leaves: ``router`` (D, E) float32, ``w_gate`` and
    ``w_up`` (E * factor, D, F / factor), ``w_down`` (E * factor,
    F / factor, D); under a mesh this rank's rows (and ``efsdp`` part of
    D)."""

    LEAVES = ("router", "w_gate", "w_up", "w_down")

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router = weight(router)
        self.w_gate = weight(w_gate)
        self.w_up = weight(w_up)
        self.w_down = weight(w_down)


def moe_factor(cfg: ModelConfig) -> int:
    """d_ff split factor so experts fill the whole expert axis (1 with no
    mesh).  Raises ``ValueError`` where they do not divide."""
    axis = ctx.axis_size("expert")
    if axis <= cfg.n_experts:
        if cfg.n_experts % axis:
            raise ValueError(f"{cfg.name}: {cfg.n_experts} experts over {axis} ranks")
        return 1
    factor = axis // cfg.n_experts
    if axis % cfg.n_experts or cfg.d_ff % factor:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts of d_ff {cfg.d_ff} over "
                         f"{axis} ranks")
    return factor


def init_moe_params(
    cfg: ModelConfig, generator: torch.Generator, dtype: torch.dtype, device
) -> MoE:
    """Random leaves with the reference's scales (``D**-0.5``, and
    ``d_ff**-0.5`` for ``w_down``), drawn in float32 from ``generator``;
    the experts in ``dtype``, stored pre-split as ``(E * factor, D,
    d_ff / factor)`` (:func:`moe_factor`), the router in float32."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    factor = moe_factor(cfg)
    rows, f_loc = e * factor, f // factor

    def normal(shape, scale, dt=dtype):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return t.mul_(scale).to(dt)

    return MoE(
        normal((d, e), d**-0.5, torch.float32),
        normal((rows, d, f_loc), d**-0.5),
        normal((rows, d, f_loc), d**-0.5),
        normal((rows, f_loc, d), f**-0.5),
    )


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert has for ``tokens`` routed tokens (at least 4, at
    most ``tokens``)."""
    c = math.ceil(cfg.capacity_factor * tokens * cfg.experts_per_token / cfg.n_experts)
    return max(4, min(c, tokens))


# ---------------------------------------------------------------------------
# Dropped assignments, counted on request
# ---------------------------------------------------------------------------

_TALLY = threading.local()


@contextlib.contextmanager
def drop_tally():
    """Inside, every routing of this thread appends the (token, expert)
    assignments it dropped for want of capacity (a 0-dim tensor, this
    rank's tokens) to the yielded list."""
    prev = getattr(_TALLY, "drops", None)
    _TALLY.drops = drops = []
    try:
        yield drops
    finally:
        _TALLY.drops = prev


def _tally(dropped) -> None:
    """Append ``dropped()`` to the open :func:`drop_tally`, if any."""
    drops = getattr(_TALLY, "drops", None)
    if drops is not None:
        drops.append(dropped())


@contextlib.contextmanager
def choice_record():
    """Inside, every routing of this thread appends its expert choices
    (``top_i``, (T, k) int64, by falling probability) to the yielded
    list, one entry an MoE layer in the order the layers run."""
    prev = getattr(_TALLY, "choices", None)
    _TALLY.choices = choices = []
    try:
        yield choices
    finally:
        _TALLY.choices = prev


# ---------------------------------------------------------------------------
# Routing and the single-rank dispatch
# ---------------------------------------------------------------------------


class Routing(NamedTuple):
    top_p: torch.Tensor  # (T, k) float32: the chosen experts' (renormalised) probabilities
    top_i: torch.Tensor  # (T, k) int64: the chosen experts, by falling probability
    keep: torch.Tensor  # (T, E) bool: token t holds a slot of expert e
    slot: torch.Tensor  # (T, E) int64: its slot, or C (the overflow bin) where not kept
    aux: torch.Tensor  # () float32: the Switch-style balance loss


def _select(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor):
    """The router's top-k of ``x`` (T, D): ``(top_p, top_i, aux)``."""
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(x.float() @ router, dim=-1)  # (T, E)
    # jax.lax.top_k puts the lower index first among equal values; a
    # stable descending sort does the same (torch.topk promises no order)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    if cfg.moe_renormalize:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    choices = getattr(_TALLY, "choices", None)
    if choices is not None:
        choices.append(top_i)

    me = probs.mean(dim=0)
    ones = torch.ones(T * k, dtype=torch.float32, device=x.device)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, top_i.reshape(-1), ones) / (T * k)
    return top_p, top_i, E * torch.sum(me * ce)


def _slots(mask: torch.Tensor, capacity: int, overflow: int):
    """Per column of ``mask`` (N, M), each set entry's position among the
    column's set entries: ``(keep, slot)``, kept where below ``capacity``,
    the slot ``overflow`` where not.  The scan runs along the rows as the
    innermost dimension (PyTorch's scan over the outer one took 0.77 ms at
    4,096 tokens x 128 experts on an H100)."""
    pos = torch.cumsum(mask.T.to(torch.int64).contiguous(), dim=1).T - 1
    keep = mask & (pos < capacity)
    return keep, torch.where(keep, pos, overflow)


def route(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor, capacity: int) -> Routing:
    """The reference's routing of ``x`` (T, D) over all experts."""
    T = x.shape[0]
    top_p, top_i, aux = _select(cfg, x, router)
    # combine weight per (token, expert); a selection whose weight
    # underflowed to 0 counts as unselected, as in the reference
    gate = torch.zeros((T, cfg.n_experts), dtype=torch.float32, device=x.device)
    chosen = gate.scatter_(1, top_i, top_p) > 0.0
    keep, slot = _slots(chosen, capacity, capacity)
    _tally(lambda: chosen.sum() - keep.sum())
    return Routing(top_p, top_i, keep, slot, aux)


def _gather_rows(x: torch.Tensor, src: torch.Tensor, shape) -> torch.Tensor:
    """Rows ``src`` of ``x`` with a zero row appended (``src == len(x)``
    reads zeros), viewed as ``shape``."""
    x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return x_pad.index_select(0, src).view(shape)


def _expert_ffn(buf, w_gate, w_up, w_down):
    """Every buffer row through its expert: ``silu(b wg) * (b wu) @ wd``."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _dispatch(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor, e_loc: int,
              first_expert: int, factor: int):
    """Route ``x`` (T, D) over every expert and fill this rank's ``e_loc``
    expert rows, row ``s`` serving expert ``(first_expert + s) //
    factor``: returns ``(buf (e_loc, C+1, D), flat, kept, routing)`` where
    ``flat`` (T, k) is each choice's row in the flattened buffer and
    ``kept`` whether it holds one (its expert is here and kept it)."""
    T, D = x.shape
    C = _capacity(cfg, T)
    r = route(cfg, x, router, C)
    # with factor > 1 a rank holds one row (e_loc == 1), part of one expert
    local = r.top_i - first_expert // factor
    kept = r.keep.gather(1, r.top_i)
    if first_expert or e_loc != cfg.n_experts:
        kept = kept & (local >= 0) & (local < e_loc)
        local = local.clamp(0, e_loc - 1)
    # each (token, choice) pair's row in the (e_loc * (C+1)) buffer;
    # dropped pairs land in their expert's overflow row C, which stays zero
    flat = local * (C + 1) + r.slot.gather(1, r.top_i)  # (T, k)
    tokens = torch.arange(T, device=x.device)[:, None].expand_as(flat)
    # the token each buffer row holds, T (a zero row) where none; a
    # dropped pair writes to one extra row past the buffer, thrown away
    src = torch.full((e_loc * (C + 1) + 1,), T, dtype=torch.int64, device=x.device)
    src[torch.where(kept, flat, e_loc * (C + 1))] = tokens
    return _gather_rows(x, src[:-1], (e_loc, C + 1, D)), flat, kept, r


def _combine(y: torch.Tensor, flat, kept, top_p, dtype, *, partial: bool = False):
    """Each token's kept choices' rows of ``y`` (rows, D), weighted by
    their gates in ``dtype`` (the reference's note c2) and summed; in
    float32 where the sum is a ``partial`` one that other ranks add to
    (see ``context.matmul_psum``).  ``kept`` ``None``: every choice."""
    T, D = flat.shape[0], y.shape[-1]
    w = (top_p if kept is None else torch.where(kept, top_p, 0.0)).to(dtype)
    terms = y.index_select(0, flat.reshape(-1)).view(T, -1, D) * w[..., None]
    return terms.sum(dim=1, dtype=torch.float32 if partial else None)


def local_moe(
    cfg: ModelConfig,
    x: torch.Tensor,  # (T, D) tokens in the compute dtype
    router: torch.Tensor,  # (D, E) float32
    w_gate: torch.Tensor,  # (E_loc, D, F_loc): this rank's expert rows
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # (E_loc, F_loc, D)
    first_expert: int = 0,  # global row of local row 0
    factor: int = 1,
    *,
    partial: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's experts over ``x``: ``(out (T, D), aux)``, the
    counterpart of the reference's ``_local_moe``; ``out`` in x's dtype,
    or with ``partial`` (the rank holds some of the experts) the partial
    combine in float32.  A dropless config takes :func:`_dropless`."""
    if cfg.moe_dropless:
        return _dropless(cfg, x, router, w_gate, w_up, w_down)
    with span("moe.route"):
        buf, flat, kept, r = _dispatch(cfg, x, router, w_gate.shape[0], first_expert, factor)
    with span("moe.experts"):
        y = _expert_ffn(buf, w_gate, w_up, w_down)
    with span("moe.combine"):
        out = _combine(y.view(-1, x.shape[1]), flat, kept, r.top_p, x.dtype, partial=partial)
    return out, r.aux


def _dropless(cfg: ModelConfig, x, router, w_gate, w_up, w_down):
    """Every expert over every token that chose it, none dropped: ``(out
    (T, D) in x's dtype, aux)``.  The T * k (token, choice) pairs are
    sorted by expert (stably, so in token order within an expert), so
    expert ``e``'s rows end at ``ends[e]``, found on the device; each of
    the three products is one grouped product over those rows.  Each
    pair's output row is then found through the inverse of the sort, and
    each token's k rows are weighted and summed in the order of its
    choices."""
    T = x.shape[0]
    k = cfg.experts_per_token
    with span("moe.route"):
        top_p, top_i, aux = _select(cfg, x, router)
        by_expert, order = torch.sort(top_i.reshape(-1), stable=True)
        experts = torch.arange(cfg.n_experts, device=x.device)
        ends = torch.searchsorted(by_expert, experts, right=True).to(torch.int32)
        rows = x.index_select(0, order // k)  # (T * k, D), grouped by expert
    with span("moe.experts"):
        h = F.silu(torch._grouped_mm(rows, w_gate, offs=ends)) * torch._grouped_mm(
            rows, w_up, offs=ends)
        y = torch._grouped_mm(h, w_down, offs=ends)  # (T * k, D)
    with span("moe.combine"):
        pair_row = torch.empty_like(order).scatter_(0, order,
                                                    torch.arange(T * k, device=x.device))
        out = _combine(y, pair_row.view(T, k), None, top_p, x.dtype)
    return out, aux


def _local_moe_sharded_weights(cfg, x, router, w_gate, w_up, w_down, first_expert: int,
                               factor: int, fsdp_axes: tuple[str, ...], *,
                               partial: bool = False):
    """Decode-time expert compute against ``efsdp`` weight shards
    (``w_gate`` (E_loc, D/f, F_loc), ``w_down`` (E_loc, F_loc, D/f)):
    contract this rank's D-slice of the buffers, add the (C+1, F) partials
    over ``fsdp_axes``, and gather the outputs' D-slices back; no weight
    moves.  Returns what :func:`local_moe` does."""
    D = x.shape[1]
    buf, flat, kept, r = _dispatch(cfg, x, router, w_gate.shape[0], first_expert, factor)
    d_loc = w_gate.shape[1]
    buf = buf.narrow(2, ctx.axis_index(fsdp_axes) * d_loc, d_loc)
    g = ctx.matmul_psum(buf, w_gate, fsdp_axes)
    u = ctx.matmul_psum(buf, w_up, fsdp_axes)
    y = ctx.all_gather(torch.bmm(F.silu(g) * u, w_down), fsdp_axes, 2,
                       adjoint="slice")  # (E_loc, C+1, D)
    return _combine(y.reshape(-1, D), flat, kept, r.top_p, x.dtype, partial=partial), r.aux


def _mesh_axes(cfg: ModelConfig):
    """``(expert axes, efsdp axes, rows' batch axes)`` of the active
    mesh; raises ``ValueError`` on a mesh without an expert axis, and for
    a dropless config (its experts run on one device)."""
    if cfg.moe_dropless:
        raise ValueError(f"{cfg.name}: the dropless MoE runs on one device; the mesh paths "
                         f"route at a capacity")
    ep = ctx.physical_axes("expert")
    if not ep:
        raise ValueError(f"{cfg.name}: the mesh has no expert axis")
    return ep, ctx.physical_axes("efsdp"), ctx.batch_axes()


def _gathered_experts(p: MoE, fsdp: tuple[str, ...]):
    """``(w_gate, w_up, w_down)`` with their ``d_model`` dim gathered over
    the ``efsdp`` axes (each rank's tokens differ, so the gradients are
    summed over the ranks before each takes its block)."""
    if not fsdp:
        return p.w_gate, p.w_up, p.w_down
    return (ctx.all_gather(p.w_gate, fsdp, 1, adjoint="sum"),
            ctx.all_gather(p.w_up, fsdp, 1, adjoint="sum"),
            ctx.all_gather(p.w_down, fsdp, 2, adjoint="sum"))


def moe_ffn(cfg: ModelConfig, p: MoE, x: torch.Tensor, *, decode: bool = False):
    """MoE FFN over ``x`` (B, S, D), this rank's rows under a mesh:
    ``(out (B, S, D) in x's dtype, aux)``.  With no mesh every expert runs
    here; under one, the gather path or (``decode`` with ``efsdp``
    shards) the no-gather path."""
    B, S, D = x.shape
    factor = moe_factor(cfg)
    if ctx.current_mesh() is None:
        out, aux = local_moe(cfg, x.reshape(B * S, D), p.router, p.w_gate, p.w_up, p.w_down)
        return out.view(B, S, D), aux

    ep, fsdp, batch = _mesh_axes(cfg)
    e_loc = p.w_gate.shape[0]
    first = ctx.axis_index(ep) * e_loc
    partial = ctx.current_mesh().axes_size(ep) > 1  # summed over ep in float32
    x, router = ctx.fan_out(x, ep), ctx.fan_out(p.router, ep)
    if decode and fsdp:
        # every efsdp rank must hold the same tokens: gather the rows over
        # the batch axes the weights are sharded over
        over = tuple(a for a in batch if a in fsdp)
        batch = tuple(a for a in batch if a not in fsdp)
        xs = ctx.all_gather(x, over, 0, adjoint="sum")
        out, aux = _local_moe_sharded_weights(
            cfg, xs.reshape(-1, D), router, p.w_gate, p.w_up, p.w_down, first, factor, fsdp,
            partial=partial)
        out = ctx.local_rows(ctx.psum(out.view(xs.shape), ep).to(x.dtype), over)
    else:
        wg, wu, wd = _gathered_experts(p, fsdp)
        out, aux = local_moe(cfg, x.reshape(B * S, D), router, wg, wu, wd, first, factor,
                             partial=partial)
        out = ctx.psum(out, ep).to(x.dtype).view(B, S, D)
    return out, ctx.pmean(ctx.pmean(aux, ep), batch)


def moe_ffn_a2a(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """Expert parallelism with all-to-all dispatch over ``x`` (B, S, D),
    this rank's rows: each model rank routes its slice of the sequence and
    exchanges tokens (with their gates, in the compute dtype) with the
    ranks owning their experts.  With no mesh it *is* :func:`moe_ffn`.
    Needs ``moe_factor == 1`` and ``S`` divisible by the expert axis."""
    B, S, D = x.shape
    if moe_factor(cfg) != 1:
        raise ValueError(f"{cfg.name}: the a2a path needs n_experts >= the expert axis")
    if ctx.current_mesh() is None:
        return moe_ffn(cfg, p, x)

    ep, fsdp, batch = _mesh_axes(cfg)
    n = ctx.current_mesh().axes_size(ep)
    e_loc = cfg.n_experts // n
    if S % n:
        raise ValueError(f"{cfg.name}: a2a needs the sequence ({S}) to split over {n} ranks")
    k, cf = cfg.experts_per_token, cfg.capacity_factor
    wg, wu, wd = _gathered_experts(p, fsdp)
    sl = S // n
    xt = ctx.fan_out(x, ep).narrow(1, ctx.axis_index(ep) * sl, sl).reshape(-1, D)
    t_loc = xt.shape[0]
    top_p, top_i, aux = _select(cfg, xt, ctx.fan_out(p.router, ep))

    # per destination rank: which tokens go there and their gates for its
    # experts; a token dropped for capacity is *added* as zeros into the
    # last slot, which a kept token may hold
    c_send = max(4, math.ceil(cf * t_loc * k / n))
    dest = top_i // e_loc  # (T_loc, k)
    on = dest[:, :, None] == torch.arange(n, device=x.device)  # (T_loc, k, n)
    keep, slot = _slots(on.any(dim=1), c_send, c_send - 1)  # (T_loc, n)
    _tally(lambda: ((top_p > 0) & ~keep.gather(1, dest)).sum())
    rows = torch.arange(t_loc, device=x.device)
    gates = torch.zeros((t_loc, n, e_loc), dtype=torch.float32, device=x.device)
    gates.index_put_((rows[:, None].expand_as(dest), dest, top_i % e_loc), top_p,
                     accumulate=True)
    payload = torch.cat([xt[:, None].expand(t_loc, n, D), gates.to(x.dtype)], dim=2)
    send = x.new_zeros((n, c_send, D + e_loc))
    ranks = torch.arange(n, device=x.device)[None].expand(t_loc, n)
    send.index_put_((ranks, slot), payload.masked_fill(~keep[..., None], 0), accumulate=True)

    recv = ctx.all_to_all(send, ep).view(n * c_send, D + e_loc)
    rx, rgates = recv[:, :D], recv[:, D:].float()

    # second-level dispatch: received tokens -> this rank's experts
    r_tokens = n * c_send
    c2 = max(4, math.ceil(cf * r_tokens / e_loc))
    keep2, slot2 = _slots(rgates > 0.0, c2, c2)  # (R, e_loc)
    _tally(lambda: (rgates > 0.0).sum() - keep2.sum())
    flat2 = torch.arange(e_loc, device=x.device) * (c2 + 1) + slot2
    src = torch.full((e_loc * (c2 + 1) + 1,), r_tokens, dtype=torch.int64, device=x.device)
    src[torch.where(keep2, flat2, e_loc * (c2 + 1))] = (
        torch.arange(r_tokens, device=x.device)[:, None].expand_as(flat2))
    buf = _gather_rows(rx, src[:-1], (e_loc, c2 + 1, D))
    ye = _expert_ffn(buf, wg, wu, wd).view(-1, D)
    # a row carries the gates of at most k of its token's experts: combine
    # those, not every local expert's (R, D) row
    g, e = rgates.topk(min(k, e_loc), dim=1)
    y = _combine(ye, flat2.gather(1, e), keep2.gather(1, e), g, x.dtype)  # (R, D)

    back = ctx.all_to_all(y.view(n, c_send, D), ep).view(n * c_send, D)
    picked = back.index_select(0, (ranks * c_send + slot).reshape(-1)).view(t_loc, n, D)
    out = picked.masked_fill(~keep[..., None], 0).sum(dim=1)
    out = ctx.all_gather(out.view(B, sl, D), ep, 1, adjoint="slice")
    return out, ctx.pmean(ctx.pmean(aux, batch), ep)


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor, *, decode: bool = False):
    """Dispatch on ``cfg.moe_impl`` (gather vs all-to-all expert
    parallelism): ``(out (B, S, D) in x's dtype, aux)``.  Decode steps and
    split experts take the gather paths, as in the reference."""
    if cfg.moe_impl == "a2a" and moe_factor(cfg) == 1 and not decode:
        return moe_ffn_a2a(cfg, p, x)
    return moe_ffn(cfg, p, x, decode=decode)
