"""Mesh construction, the per-cell sharding policy, and the cuts of a
parameter tree, a batch and a cache to this rank's shards (port of
``repro.launch.mesh``).

``make_production_mesh`` builds a :class:`~repro_torch.parallel.context.Mesh`
over the default process group: ``("data", "model")`` = (world / local
ranks, local ranks), so the model axis stays within a host, and with
``multi_pod`` a leading ``"pod"`` axis of 2.  The reference's 16 x 16 and
2 x 16 x 16 are a TPU pod's shapes.

Where the reference hands GSPMD a ``NamedSharding`` per leaf
(``tree_shardings``, ``batch_shardings``), the port cuts each leaf to the
rows and columns this rank holds (:func:`shard_params`,
:func:`shard_cache`; a batch's rows are cut by the model's entry points,
``context.local_rows``) and the layers run their own collectives.  The cuts follow the reference's ``param_specs``, with the
shapes a rank must own whole:

* attention: ``wq`` by heads, ``wk``/``wv`` by the KV heads those heads
  read (replicated where there are fewer KV heads than ranks, so no head
  is split mid-way as GSPMD splits the ``Kv * dh`` columns), ``wo`` by
  rows; with fewer heads than ranks each head's ranks hold its rows in
  equal parts of ``dh``;
* SwiGLU by ``d_ff``; mamba by ``d_inner`` channels (``in_proj``'s x and
  z halves each by channel, ``x_proj`` by rows); the embedding and
  ``lm_head`` by vocabulary;
* MoE expert rows over ``expert`` and their ``d_model`` dim over
  ``efsdp``; the router replicated.

Dense FSDP (``"fsdp"`` over ``data``) is left out: dense weights are
replicated over the data axis, which computes the same function; it
waits for ROADMAP §1 P14b with training across ranks.
``advise_mesh_shape`` waits for ``rank_meshes`` (ROADMAP §1 P13).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.attention import KVCache, head_layout
from repro_torch.models.layers import weight
from repro_torch.models.mamba import MambaCache
from repro_torch.models.model import EncDecCache, _with_leaves
from repro_torch.models.moe import moe_factor
from repro_torch.parallel import context as ctx

GB = 1 << 30

# Serving keeps parameters replicated over the data axis when one model
# rank's share of the bf16 weights takes at most this share of the card,
# the rest left to caches and activations; larger models shard their
# experts over data too (the no-gather decode path).
SERVE_REPLICATION_SHARE = 0.25
# The card the port is built for (an H100 80GB), for ranks on the CPU.
NOMINAL_CARD_BYTES = 80 * GB


def make_production_mesh(*, multi_pod: bool = False, local: int | None = None) -> ctx.Mesh:
    """The serving mesh over the default process group: ``("data",
    "model")`` of (world / local, local), or ``("pod", "data", "model")``
    of (2, world / (2 local), local).  ``local`` defaults to torchrun's
    ``LOCAL_WORLD_SIZE`` (else the world).  Raises ``ValueError`` where
    the world does not divide."""
    world = dist.get_world_size()
    local = local or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    pods = 2 if multi_pod else 1
    if local < 1 or world % (pods * local):
        raise ValueError(f"{world} ranks do not split into {pods} pod(s) of hosts of {local} ranks")
    if multi_pod:
        return ctx.make_mesh((pods, world // (pods * local), local), ("pod", "data", "model"))
    return ctx.make_mesh((world // local, local), ("data", "model"))


def candidate_mesh_axes(
    n_devices: int,
    *,
    axis_names: tuple[str, str] = ("data", "model"),
    min_model: int = 1,
    max_model: int | None = None,
) -> list[dict[str, int]]:
    """Every 2-axis factorization of ``n_devices`` (model axis between
    ``min_model`` and ``max_model``), in advisor candidate form."""
    if n_devices < 1:
        raise ValueError("need >= 1 device")
    if max_model is None:
        max_model = n_devices
    outer, inner = axis_names
    out = []
    for model in range(min_model, max_model + 1):
        if n_devices % model:
            continue
        out.append({outer: n_devices // model, inner: model})
    if not out:
        raise ValueError(
            f"no factorization of {n_devices} devices with model axis in "
            f"[{min_model}, {max_model}]"
        )
    return out


def card_bytes() -> int:
    """The memory of this process's card, or ``NOMINAL_CARD_BYTES``
    without one."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    return NOMINAL_CARD_BYTES


def serve_params_replicated(cfg: ModelConfig, *, tp: int = 1) -> bool:
    """True when the bf16 parameters over ``tp`` model ranks fit in
    ``SERVE_REPLICATION_SHARE`` of a card."""
    return cfg.param_count() * 2 / tp <= SERVE_REPLICATION_SHARE * card_bytes()


@contextlib.contextmanager
def cell_context(mesh: ctx.Mesh, cfg: ModelConfig, shape: ShapeConfig):
    """Activate the mesh + the logical-axis policy for one (arch, shape)
    cell: decode-cache layout and the serve-time FSDP decision."""
    overrides = {}
    axis_names = mesh.axis_names
    sizes = mesh.shape
    batch_axes = tuple(a for a in ("pod", "data") if a in axis_names)

    if shape.kind in ("decode", "prefill"):
        if not serve_params_replicated(cfg, tp=sizes.get("model", 1)):
            overrides["fsdp"] = ("data",)  # prefill: gathers amortized by T
        else:
            # small enough to replicate over data — dense AND expert weights
            overrides["fsdp"] = ()
            overrides["efsdp"] = ()
    if shape.kind == "decode":
        usable = [a for a in batch_axes if shape.global_batch % sizes[a] == 0]
        cache_batch = tuple(usable) if shape.global_batch > 1 else ()
        overrides["cache_batch"] = cache_batch
        overrides["cache_seq"] = tuple(a for a in axis_names if a not in cache_batch)
    with ctx.use_mesh(mesh), ctx.use_logical_rules(**overrides):
        yield


# ---------------------------------------------------------------------------
# Cuts: which indices of each leaf a rank holds
# ---------------------------------------------------------------------------


def _block(n: int, parts: int, i: int) -> torch.Tensor:
    if n % parts:
        raise ValueError(f"a dim of {n} does not split over {parts} ranks")
    return torch.arange(i * n // parts, (i + 1) * n // parts)


def _span(logical: str, mesh: ctx.Mesh, rank: int) -> tuple[int, int]:
    """(ranks, this rank's index) over a logical dim's axes."""
    axes = ctx.physical_axes(logical)
    return mesh.axes_size(axes), mesh.axis_index(axes, rank)


def _attn_plan(cfg, leaf: str, mesh: ctx.Mesh, rank: int) -> list:
    tp, i = _span("tp", mesh, rank)
    if tp == 1:
        return []
    lay = head_layout(cfg, tp, i)
    dh = cfg.head_dim
    if leaf == "wq":
        return [(1, torch.arange(lay.q0 * dh, (lay.q0 + lay.heads) * dh))]
    if leaf in ("wk", "wv"):
        return [(1, torch.arange(lay.kv0 * dh, (lay.kv0 + lay.kv_heads) * dh))]
    return [(0, torch.arange(lay.wo0, lay.wo0 + lay.wo_rows))]


def _mamba_plan(cfg, leaf: str, mesh: ctx.Mesh, rank: int) -> list:
    tp, i = _span("tp", mesh, rank)
    if tp == 1:
        return []
    ch = _block(cfg.d_inner, tp, i)
    if leaf == "in_proj":  # [x | z]: each half by channel
        return [(1, torch.cat([ch, ch + cfg.d_inner]))]
    return [({"conv_w": 1, "dt_proj": 1}.get(leaf, 0), ch)]


def _ffn_plan(cfg, leaf: str, ndim: int, mesh: ctx.Mesh, rank: int) -> list:
    if ndim == 3:  # MoE experts: rows over "expert", d_model over "efsdp"
        ep, i = _span("expert", mesh, rank)
        nf, j = _span("efsdp", mesh, rank)
        rows = cfg.n_experts * moe_factor(cfg)
        plan = [(0, _block(rows, ep, i))] if ep > 1 else []
        if nf > 1:
            plan.append((2 if leaf == "w_down" else 1, _block(cfg.d_model, nf, j)))
        return plan
    tp, i = _span("tp", mesh, rank)
    return [] if tp == 1 else [(0 if leaf == "w_down" else 1, _block(cfg.d_ff, tp, i))]


def _param_plan(cfg, name: str, ndim: int, mesh: ctx.Mesh, rank: int) -> list:
    """``[(dim, indices), ...]`` of the parameter ``name`` held by
    ``rank``: the dims cut over more than one rank."""
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if name in ("embed.table", "lm_head"):
        tp, i = _span("tp", mesh, rank)
        return [] if tp == 1 else [(int(name == "lm_head"), _block(cfg.padded_vocab, tp, i))]
    if parent in ("mixer", "cross") and leaf in ("wq", "wk", "wv", "wo"):
        return _attn_plan(cfg, leaf, mesh, rank)
    if parent == "mixer":
        return _mamba_plan(cfg, leaf, mesh, rank)
    if parent == "ffn" and leaf != "router":
        return _ffn_plan(cfg, leaf, ndim, mesh, rank)
    return []


def _cut(t: torch.Tensor, plan: list) -> torch.Tensor:
    for dim, idx in plan:
        t = t.index_select(dim, idx.to(t.device))
    return t


def shard_params(cfg: ModelConfig, lm):
    """This rank's shards of a whole :class:`~repro_torch.models.model.LM`
    under the active mesh and rules: a shallow copy whose cut leaves are
    new, the rest shared (everything shared with no mesh or one rank)."""
    mesh = ctx.current_mesh()
    if mesh is None:
        return lm
    leaves = {}
    for name, p in lm.named_parameters():
        plan = _param_plan(cfg, name, p.ndim, mesh, mesh.rank)
        if plan:
            leaves[name] = weight(_cut(p.detach(), plan))
    return _with_leaves(lm, leaves) if leaves else lm


def gather_params(cfg: ModelConfig, lm):
    """The inverse of :func:`shard_params`: every rank gets the whole
    :class:`~repro_torch.models.model.LM` back (one all-gather per cut
    leaf over the whole mesh)."""
    mesh = ctx.current_mesh()
    if mesh is None:
        return lm
    leaves = {}
    for name, p in lm.named_parameters():
        plans = [_param_plan(cfg, name, p.ndim, mesh, q) for q in range(mesh.size)]
        if not plans[mesh.rank]:
            continue
        parts = ctx.all_gather(p.detach()[None], mesh.axis_names, 0)
        full = list(p.shape)
        for plan in plans:
            for dim, idx in plan:
                full[dim] = max(full[dim], int(idx.max()) + 1)
        out = p.new_zeros(full)
        for q, plan in enumerate(plans):
            index = [torch.arange(n, device=p.device) for n in p.shape]
            for dim, idx in plan:
                index[dim] = idx.to(p.device)
            out[tuple(ix.view([-1 if d == k else 1 for k in range(p.ndim)])
                      for d, ix in enumerate(index))] = parts[q]
        leaves[name] = weight(out)
    return _with_leaves(lm, leaves) if leaves else lm


def shard_cache(cfg: ModelConfig, cache):
    """This rank's part of a whole decode cache (``model.init_cache``'s
    layout) under the active mesh and rules, for a batch whose rows lie
    over :func:`~repro_torch.parallel.context.divisible_batch_axes`: each
    attention cache's rows and the KV heads of this rank's heads, each
    mamba cache's rows and channels.  Returns ``cache`` itself with no
    mesh."""
    mesh = ctx.current_mesh()
    if mesh is None:
        return cache
    tp, i = _span("tp", mesh, mesh.rank)

    def rows(t):
        return ctx.local_rows(t, ctx.divisible_batch_axes(t.shape[0]))

    def cut(entry):
        if isinstance(entry, KVCache):
            if tp > 1:
                lay = head_layout(cfg, tp, i)
                entry = KVCache(*(t.narrow(2, lay.kv0, lay.kv_heads) for t in entry))
            return KVCache(*(rows(t).contiguous() for t in entry))
        conv, ssm = entry
        if tp > 1:
            ch = _block(cfg.d_inner, tp, i)
            conv, ssm = _cut(conv, [(2, ch)]), _cut(ssm, [(1, ch)])
        return MambaCache(rows(conv).contiguous(), rows(ssm).contiguous())

    if isinstance(cache, EncDecCache):
        return EncDecCache([cut(c) for c in cache.layers], [cut(c) for c in cache.cross])
    return [cut(c) for c in cache]


# ---------------------------------------------------------------------------
# Process group for a serving job
# ---------------------------------------------------------------------------


def init_distributed(device: str | torch.device) -> tuple[torch.device, bool]:
    """Join torchrun's job (``env://``) unless a default process group is
    already up: gloo for ``cpu``, NCCL on ``cuda:LOCAL_RANK`` for ``cuda``.
    Returns ``(this rank's device, whether this call created the group)``
    (the creator destroys it)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev, False
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev, True

