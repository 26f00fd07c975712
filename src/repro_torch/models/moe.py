"""Mixture-of-Experts FFN on one device (port of the single-device path
of ``repro.models.moe``: ``moe_ffn`` with no mesh, i.e. ``_local_moe``
over every expert, ``factor`` 1).

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
the keep mask equal the reference's.  Multi-card expert parallelism
waits for ROADMAP §1 P14 (multi-card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import weight


class MoE(nn.Module):
    """One MoE FFN's leaves: ``router`` (D, E) float32, ``w_gate`` and
    ``w_up`` (E, D, F), ``w_down`` (E, F, D)."""

    LEAVES = ("router", "w_gate", "w_up", "w_down")

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router = weight(router)
        self.w_gate = weight(w_gate)
        self.w_up = weight(w_up)
        self.w_down = weight(w_down)


def init_moe_params(
    cfg: ModelConfig, generator: torch.Generator, dtype: torch.dtype, device
) -> MoE:
    """Random leaves with the reference's scales (``D**-0.5``, and
    ``d_ff**-0.5`` for ``w_down``), drawn in float32 from ``generator``;
    the experts in ``dtype``, the router in float32."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, scale, dt=dtype):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return t.mul_(scale).to(dt)

    return MoE(
        normal((d, e), d**-0.5, torch.float32),
        normal((e, d, f), d**-0.5),
        normal((e, d, f), d**-0.5),
        normal((e, f, d), f**-0.5),
    )


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert has for ``tokens`` routed tokens (at least 4, at
    most ``tokens``)."""
    c = math.ceil(cfg.capacity_factor * tokens * cfg.experts_per_token / cfg.n_experts)
    return max(4, min(c, tokens))


class Routing(NamedTuple):
    top_p: torch.Tensor  # (T, k) float32: renormalised probabilities of the chosen experts
    top_i: torch.Tensor  # (T, k) int64: the chosen experts, by falling probability
    keep: torch.Tensor  # (T, E) bool: token t holds a slot of expert e
    slot: torch.Tensor  # (T, E) int64: its slot, or C (the overflow bin) where not kept
    aux: torch.Tensor  # () float32: the Switch-style balance loss


def route(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor, capacity: int) -> Routing:
    """The reference's routing of ``x`` (T, D) over all experts."""
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(x.float() @ router, dim=-1)  # (T, E)
    # jax.lax.top_k puts the lower index first among equal values; a
    # stable descending sort does the same (torch.topk promises no order)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    me = probs.mean(dim=0)
    ones = torch.ones(T * k, dtype=torch.float32, device=x.device)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, top_i.reshape(-1), ones) / (T * k)
    aux = E * torch.sum(me * ce)

    # combine weight per (token, expert); a selection whose weight
    # underflowed to 0 counts as unselected, as in the reference
    gate = torch.zeros((T, E), dtype=torch.float32, device=x.device).scatter_(1, top_i, top_p)
    mask = gate > 0.0
    # each token's position within each expert; the scan runs along the
    # tokens as the innermost dimension (PyTorch's scan over the outer one
    # took 0.77 ms at 4,096 tokens x 128 experts on an H100)
    pos = torch.cumsum(mask.T.to(torch.int64).contiguous(), dim=1).T - 1
    keep = mask & (pos < capacity)
    slot = torch.where(keep, pos, capacity)
    return Routing(top_p, top_i, keep, slot, aux)


def local_moe(
    cfg: ModelConfig,
    x: torch.Tensor,  # (T, D) tokens in the compute dtype
    router: torch.Tensor,  # (D, E) float32
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # (E, F, D)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every expert over ``x``: ``(out (T, D) in x's dtype, aux)``, the
    counterpart of the reference's ``_local_moe`` at ``first_expert`` 0
    and ``factor`` 1."""
    T, D = x.shape
    E = cfg.n_experts
    C = _capacity(cfg, T)
    r = route(cfg, x, router, C)

    # each (token, choice) pair's row in the (E * (C+1)) buffer; dropped
    # pairs land in their expert's overflow row C, which stays zero
    flat = r.top_i * (C + 1) + r.slot.gather(1, r.top_i)  # (T, k)
    kept = r.keep.gather(1, r.top_i)
    tokens = torch.arange(T, device=x.device)[:, None].expand_as(flat)
    # the token each buffer row holds, T (a zero row) where none; a
    # dropped pair writes to one extra row past the buffer, thrown away
    src = torch.full((E * (C + 1) + 1,), T, dtype=torch.int64, device=x.device)
    src[torch.where(kept, flat, E * (C + 1))] = tokens
    x_pad = torch.cat([x, x.new_zeros((1, D))])
    buf = x_pad.index_select(0, src[:-1]).view(E, C + 1, D)

    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)  # (E, C+1, F)
    y = torch.bmm(h, w_down).view(E * (C + 1), D)
    # combine in the compute dtype (the reference's note c2)
    w = torch.where(kept, r.top_p, 0.0).to(x.dtype)
    out = (y.index_select(0, flat.reshape(-1)).view(T, -1, D) * w[..., None]).sum(dim=1)
    return out, r.aux


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over ``x`` (B, S, D): ``(out (B, S, D) in x's dtype,
    aux)``.  On one device prefill and decode take the same path, as in
    the reference with no mesh (its ``decode`` flag only changes the
    sharded paths).  An all-to-all request (``cfg.moe_impl == "a2a"``) or
    a process group of several ranks (a mesh) raises: expert parallelism
    across cards is not ported yet."""
    if cfg.moe_impl != "gather" or _multi_rank():
        raise NotImplementedError(
            f"{cfg.name}: expert-parallel MoE across cards (moe_impl={cfg.moe_impl!r}) "
            "waits for ROADMAP §1 P14 (multi-card)"
        )
    B, S, D = x.shape
    out, aux = local_moe(cfg, x.reshape(B * S, D), p.router, p.w_gate, p.w_up, p.w_down)
    return out.view(B, S, D), aux


def _multi_rank() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
