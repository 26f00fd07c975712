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
  ``efsdp``; the router replicated;
* dense FSDP: the ``d_model`` dim of every dense matrix over ``fsdp``
  (``data``), as the reference's specs put it (``model.fsdp_dim``); the
  forward gathers them whole (``model.cast_for_compute``).  Training
  keeps ``fsdp`` and ``efsdp`` on ``data`` (:func:`cell_context`), as the
  reference's default rules do; serving replicates small models over
  ``data``;
* 2-D decode tensor parallelism: a decode cell of a model too large to
  replicate over ``data`` cuts the dense tensor-parallel dims over
  ``("model", "data")`` instead, with no ``fsdp`` cut
  (:func:`serve_decode_param_rules`, the counterpart of the reference's
  ``serve_decode_param_shardings``): the attention projections by flat
  column blocks, as GSPMD cuts them (``attention.flat_projections``), the
  rest as above over the 2-D axes; expert weights keep their ``efsdp``
  cut.  No decode step gathers a dense weight.

The decode cache lies by sequence (:func:`shard_cache`, the reference's
``cache_specs``).

A training state (the parameter tree and AdamW's moments) is cut and
gathered leaf by leaf in the same way (:func:`shard_state`,
:func:`gather_state`), so a whole state moves to any mesh
(``runtime.fault_tolerance.remesh``).

:func:`advise_mesh_shape` ranks every 2-axis factorization of a device
count by predicted step time, through the advisor's ``rank_meshes``.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.meshsig.advisor import CHIP_V5E, rank_meshes
from repro_torch.models.attention import KVCache, projection_columns
from repro_torch.models.layers import weight
from repro_torch.models.mamba import MambaCache
from repro_torch.models.model import EncDecCache, _with_leaves, fsdp_dim
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


def advise_mesh_shape(
    sig,
    n_devices: int,
    *,
    chip=None,
    topology=None,
    axis_names: tuple[str, str] = ("data", "model"),
    min_model: int = 1,
    max_model: int | None = None,
):
    """Rank every 2-axis mesh factorization of ``n_devices`` by predicted
    step time through the advisor: the scalar roofline by default, the
    routed per-link model when a
    :class:`~repro_torch.core.meshsig.device_topology.DeviceTopology` is
    given.  ``chip`` defaults to ``CHIP_V5E``, as in the reference.
    Returns the advisor's sorted ``MeshRanking`` list (best first)."""
    candidates = candidate_mesh_axes(
        n_devices, axis_names=axis_names, min_model=min_model,
        max_model=max_model,
    )
    return rank_meshes(sig, candidates, chip=chip or CHIP_V5E, topology=topology)


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


def serve_decode_param_rules() -> dict[str, tuple[str, ...]]:
    """The logical rules of 2-D decode tensor parallelism (the reference's
    ``serve_decode_param_shardings``, its "§Perf iteration d2"): the dense
    tensor-parallel dims over ``model`` x ``data``, model major as the
    reference's ``resolve`` lays ``("model", "data")``, and no ``fsdp``
    cut, so no decode step gathers a dense weight; ``efsdp`` is left as it
    is (the experts' no-gather decode path).  The reference scopes these
    rules to the parameter tree and lets GSPMD move the activations; here
    the layers run on them too: they sum their row-cut products over
    both axes, and the decode rows are not cut over an axis of ``tp``
    (``context.use_batch_rows``)."""
    return {"fsdp": (), "tp": ("model", "data")}


@contextlib.contextmanager
def cell_context(mesh: ctx.Mesh, cfg: ModelConfig, shape: ShapeConfig):
    """Activate the mesh + the logical-axis policy for one (arch, shape)
    cell: decode-cache layout and the serve-time FSDP decision; training
    (``kind == "train"``) shards dense and expert weights over ``data``.
    A decode cell whose weights are not replicated takes 2-D tensor
    parallelism (:func:`serve_decode_param_rules`); a prefill cell keeps
    ``fsdp`` on ``data`` (its gathers amortised by the sequence)."""
    overrides = {}
    axis_names = mesh.axis_names
    sizes = mesh.shape
    batch_axes = tuple(a for a in ("pod", "data") if a in axis_names)

    if shape.kind == "train":
        overrides["fsdp"] = ("data",)
        overrides["efsdp"] = ("data",)
    replicated = serve_params_replicated(cfg, tp=sizes.get("model", 1))
    if shape.kind in ("decode", "prefill"):
        if not replicated:
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
        if not replicated:
            overrides.update(serve_decode_param_rules())
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
    start, stop = projection_columns(cfg, tp, i)[leaf]
    return [(int(leaf != "wo"), torch.arange(start, stop))]


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


def _model_plan(cfg, name: str, ndim: int, mesh: ctx.Mesh, rank: int) -> list:
    """The cuts of the parameter ``name`` over ``model`` (and the experts'
    over ``efsdp``)."""
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


def _param_plan(cfg, name: str, ndim: int, mesh: ctx.Mesh, rank: int) -> list:
    """``[(dim, indices), ...]`` of the parameter ``name`` held by
    ``rank``: the dims cut over more than one rank, a dense matrix's
    ``d_model`` dim over ``fsdp`` last."""
    plan = _model_plan(cfg, name, ndim, mesh, rank)
    dim = fsdp_dim(name, ndim)
    nf, j = _span("fsdp", mesh, rank)
    if dim is not None and nf > 1:
        plan = plan + [(dim, _block(cfg.d_model, nf, j))]
    return plan


def _cut(t: torch.Tensor, plan: list) -> torch.Tensor:
    for dim, idx in plan:
        t = t.index_select(dim, idx.to(t.device))
    return t


def _cut_leaf(cfg, name: str, t: torch.Tensor) -> torch.Tensor | None:
    """This rank's shard of the whole leaf ``t``, or ``None`` where the
    rank holds it whole."""
    mesh = ctx.current_mesh()
    plan = _param_plan(cfg, name, t.ndim, mesh, mesh.rank)
    return _cut(t.detach(), plan) if plan else None


def _gather_leaf(cfg, name: str, t: torch.Tensor) -> torch.Tensor | None:
    """The whole leaf from every rank's shard ``t`` (one all-gather over
    the whole mesh), or ``None`` where no rank cuts it."""
    mesh = ctx.current_mesh()
    plans = [_param_plan(cfg, name, t.ndim, mesh, q) for q in range(mesh.size)]
    if not plans[mesh.rank]:
        return None
    parts = ctx.all_gather(t.detach()[None], mesh.axis_names, 0, adjoint="slice")
    full = list(t.shape)
    for plan in plans:
        for dim, idx in plan:
            full[dim] = max(full[dim], int(idx.max()) + 1)
    out = t.new_zeros(full)
    for q, plan in enumerate(plans):
        index = [torch.arange(n, device=t.device) for n in t.shape]
        for dim, idx in plan:
            index[dim] = idx.to(t.device)
        out[tuple(ix.view([-1 if d == k else 1 for k in range(t.ndim)])
                  for d, ix in enumerate(index))] = parts[q]
    return out


def _map_leaves(lm, fn):
    """``lm`` with each leaf ``fn(name, leaf)`` returns (not ``None``) put
    in its place as a new inference-only leaf, the rest shared."""
    leaves = {}
    for name, p in lm.named_parameters():
        t = fn(name, p)
        if t is not None:
            leaves[name] = weight(t)
    return _with_leaves(lm, leaves) if leaves else lm


def shard_params(cfg: ModelConfig, lm):
    """This rank's shards of a whole :class:`~repro_torch.models.model.LM`
    under the active mesh and rules: a shallow copy whose cut leaves are
    new, the rest shared (everything shared with no mesh or one rank)."""
    if ctx.current_mesh() is None:
        return lm
    return _map_leaves(lm, lambda name, p: _cut_leaf(cfg, name, p))


def gather_params(cfg: ModelConfig, lm):
    """The inverse of :func:`shard_params`: every rank gets the whole
    :class:`~repro_torch.models.model.LM` back (one all-gather per cut
    leaf over the whole mesh)."""
    if ctx.current_mesh() is None:
        return lm
    return _map_leaves(lm, lambda name, p: _gather_leaf(cfg, name, p))


def _map_state(state, fn, name: str | None = None):
    """``state`` with each tensor ``t`` replaced by ``fn(name, t)``, where
    ``name`` is the parameter name of a tensor in a dict (a parameter tree
    such as ``steps.param_tree`` or AdamW's ``m`` and ``v``: its joined
    keys) and ``None`` for a tensor outside one (the step count); a
    ``None`` from ``fn`` keeps the tensor."""
    if isinstance(state, dict):
        return {k: _map_state(v, fn, k if name is None else f"{name}.{k}")
                for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_map_state(v, fn, name) for v in state))
    if isinstance(state, (list, tuple)):
        return type(state)(_map_state(v, fn, name) for v in state)
    if not isinstance(state, torch.Tensor):
        return state
    out = fn(name, state)
    return state if out is None else out


def shard_state(cfg: ModelConfig, state):
    """This rank's shards of a whole training state (a tree of parameter
    trees and moments, e.g. ``(param_tree, AdamWState)``) under the active
    mesh and rules, each leaf cut as :func:`shard_params` cuts it; the
    state itself with no mesh."""
    if ctx.current_mesh() is None:
        return state
    return _map_state(state, lambda name, t: name and _cut_leaf(cfg, name, t))


def gather_state(cfg: ModelConfig, state, *, root: int | None = None):
    """The inverse of :func:`shard_state`: the whole state on every rank
    (every rank takes part).  With ``root`` the whole state is for rank
    ``root`` alone, in its host memory, every tensor a copy of its own:
    each leaf is gathered and moved to the host before the next, so no
    device holds more than one whole leaf; the other ranks get ``None``."""
    mesh = ctx.current_mesh()
    if mesh is None:
        return state
    if root is None:
        return _map_state(state, lambda name, t: name and _gather_leaf(cfg, name, t))
    keep = mesh.rank == root

    def to_root(name, t):
        whole = name and _gather_leaf(cfg, name, t)
        if not keep:
            return None
        return t.detach().to("cpu", copy=True) if whole is None else whole.cpu()

    out = _map_state(state, to_root)
    return out if keep else None


def leaf_names(state):
    """``state`` with each tensor of a parameter tree replaced by its
    parameter name, the name :func:`shard_state` cuts it by."""
    return _map_state(state, lambda name, t: name)


def counted_leaves(cfg: ModelConfig, params) -> dict[str, bool]:
    """For each parameter name, whether this rank is the first of the
    ranks holding the same indices of it (the only one that counts it in
    a sum over the mesh, ``adamw.global_norm``)."""
    mesh = ctx.current_mesh()
    out = {}
    for name, p in params.named_parameters():
        if mesh is None or mesh.size == 1:
            out[name] = True
            continue

        def key(q):
            return [(dim, idx.tolist()) for dim, idx in _param_plan(cfg, name, p.ndim, mesh, q)]

        mine = key(mesh.rank)
        out[name] = all(key(q) != mine for q in range(mesh.rank))
    return out


def shard_cache(cfg: ModelConfig, cache):
    """This rank's part of a whole decode cache (``model.init_cache``'s
    layout) under the active mesh and rules; ``cache`` itself with no
    mesh.  The layout is the reference's ``cache_specs``:

    * an attention cache (self-attention, SWA ring, an encoder-decoder's
      cross cache): rows over ``cache_batch``, a block of the slots over
      ``cache_seq`` (``context.tile``: blocks of ``ceil(slots / ranks)``
      in row-major order over the axes, the last short or empty where the
      ranks do not divide the slots, as GSPMD pads; whisper's 1,500 frames
      over 8 ranks are seven blocks of 188 and one of 184), every KV head;
      the :class:`~repro_torch.models.attention.KVCache` records the whole
      slot count;
    * a mamba cache: channels over ``tp`` and rows over ``cache_batch``,
      as the reference's (``d_inner`` over ``model``).  Under 2-D decode
      TP (:func:`serve_decode_param_rules`) the step computes every row
      of its ``tp`` channel block, a block of ``model`` x ``data``, so its
      cache holds those channels of every row over the ``cache_batch``
      axes outside ``tp`` (the reference's layout would need the state
      gathered over ``data`` every step).

    A batch that ``cache_batch`` does not divide raises ``ValueError``."""
    mesh = ctx.current_mesh()
    if mesh is None:
        return cache
    tp, i = _span("tp", mesh, mesh.rank)
    seq = ctx.physical_axes("cache_seq")
    kv_rows = ctx.physical_axes("cache_batch")
    ssm_rows = tuple(a for a in kv_rows if a not in ctx.physical_axes("tp"))

    def cut(entry):
        if isinstance(entry, KVCache):
            start, size = ctx.tile(entry.slots, seq)
            return KVCache(*(ctx.local_rows(t, kv_rows).narrow(1, start, size).contiguous()
                             for t in (entry.k, entry.v)), length=entry.slots)
        conv, ssm = entry
        if tp > 1:
            ch = _block(cfg.d_inner, tp, i)
            conv, ssm = conv.narrow(2, int(ch[0]), len(ch)), ssm.narrow(1, int(ch[0]), len(ch))
        return MambaCache(ctx.local_rows(conv, ssm_rows).contiguous(),
                          ctx.local_rows(ssm, ssm_rows).contiguous())

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

