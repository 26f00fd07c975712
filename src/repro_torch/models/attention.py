"""Attention (port of ``repro.models.attention``): the prefill path,
whose core is K1 (``mha_flash``), and the cached decode path.

* Prefill: projections, rotary embeddings, then ``mha_flash``, which on a
  card launches the hand-written flash-attention kernel and on the CPU
  runs its plain version.  The reference's prefill core is
  ``blocked_attention``, the pure-JAX twin of the same kernel; the port
  uses the kernel itself (GQA without repeating K/V, fully masked tiles
  skipped).
* Decode: one new token against a KV cache, PyTorch tensor code (the
  reference's decode attention is no Pallas kernel either): a grouped
  einsum over the unrepeated cache, float32 logits, the softmax weights
  rounded to the cache dtype before the value product, as the reference
  does.  The cache is updated in place.
* SWA decode uses a ring buffer of window size.
* Under a mesh (tensor parallelism over ``model``) each rank holds the
  heads :func:`head_layout` gives it, their KV heads and their rows of
  ``wo``; K1 runs on those heads and the output projection's partial sums
  are added over ``model``.  In training, where ranks hold the same KV
  heads (fewer than the ranks) or the same query head (its ranks splitting
  its rows of ``wo``), each uses them in part, so their gradients are
  added over exactly those ranks (:func:`held_projections`).
* The decode cache lies by sequence, as the reference's does
  (``cache_seq``): each rank holds a block of the slots
  (``context.tile``) with all KV heads, for its rows over
  ``cache_batch``.  :func:`mha_decode` gathers the new token's q and K/V
  over ``tp`` (every rank then holds every head), the owner of the
  token's slot writes it, each rank takes its slots' float32 logits, and
  the softmax over the sharded sequence becomes a ``pmax`` of the row
  maximum and a ``psum`` of the row sums; the weights are normalised
  before they are rounded to the cache dtype, and the value products'
  float32 partials are summed over ``cache_seq`` (flash-decode, the
  reference's notes b1 and b2).  No rank gathers the cache.  Over one
  rank every step is the no-mesh arithmetic.
* Under 2-D decode tensor parallelism (``tp`` over ``("model",
  "data")``, :func:`flat_projections`) each rank holds a flat block of the
  projections' columns and of ``wo``'s rows, as GSPMD cuts them; decode
  assembles the whole heads after its gathers, so no head need lie on one
  rank.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.models.layers import rope, softcap, weight
from repro_torch.parallel import context as ctx

_NEG_INF = -1e30


class Attention(nn.Module):
    """One attention layer's projections, ``x @ w`` orientation:
    ``wq`` (D, H*dh), ``wk``/``wv`` (D, Kv*dh), ``wo`` (H*dh, D)."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq = weight(wq)
        self.wk = weight(wk)
        self.wv = weight(wv)
        self.wo = weight(wo)


def init_attn_params(
    cfg: ModelConfig, generator: torch.Generator, dtype: torch.dtype, device
) -> Attention:
    """Random projections with the reference's scales (``D**-0.5`` for
    q, k, v and ``(H*dh)**-0.5`` for o), drawn in float32 from
    ``generator`` (on ``device``) and stored in ``dtype``."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return t.mul_(scale).to(dtype)

    return Attention(
        normal((d, h * dh), d**-0.5),
        normal((d, kv * dh), d**-0.5),
        normal((d, kv * dh), d**-0.5),
        normal((h * dh, d), (h * dh) ** -0.5),
    )


class HeadLayout(NamedTuple):
    """The heads one of ``tp`` model ranks holds: query heads ``q0`` ..
    ``q0 + heads``, the KV heads ``kv0`` .. ``kv0 + kv_heads`` they read,
    and rows ``wo0`` .. ``wo0 + wo_rows`` of ``wo``."""

    q0: int
    heads: int
    kv0: int
    kv_heads: int
    wo0: int
    wo_rows: int


def head_layout(cfg: ModelConfig, tp: int, index: int) -> HeadLayout:
    """Rank ``index`` of ``tp``'s heads.  With ``n_heads % tp == 0`` each
    rank holds ``n_heads / tp`` whole heads and their rows of ``wo``; with
    ``tp % n_heads == 0`` each head is held by ``tp / n_heads`` ranks, each
    with an equal part of its ``dh`` rows of ``wo`` (GSPMD's row split).
    The KV heads are those the rank's heads read, replicated where ranks
    outnumber them.  Raises ``ValueError`` for any other split, or where a
    rank's heads would read unequal numbers of KV heads' groups."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    if h % tp == 0:
        heads = h // tp
        q0, wo0, wo_rows = index * heads, index * heads * dh, heads * dh
    elif tp % h == 0 and dh % (tp // h) == 0:
        rep = tp // h
        heads, q0 = 1, index // rep
        wo_rows = dh // rep
        wo0 = q0 * dh + (index % rep) * wo_rows
    else:
        raise ValueError(f"{cfg.name}: {h} heads of {dh} do not split over {tp} model ranks")
    if heads % g and g % heads:
        raise ValueError(f"{cfg.name}: {heads} heads a rank straddle groups of {g} query heads")
    kv0 = q0 // g
    return HeadLayout(q0, heads, kv0, (q0 + heads - 1) // g - kv0 + 1, wo0, wo_rows)


def held_projections(cfg: ModelConfig, p: Attention):
    """``(wq, wk, wv)`` as this rank computes with them: under autograd
    on a mesh, ``wk``/``wv`` pass through ``context.fan_out`` keyed by
    the first KV head a rank holds and ``wq`` keyed by its first query
    head, so a leaf's gradient is summed over the model ranks holding the
    same heads and no others."""
    tp = ctx.axis_size("tp")
    if tp == 1 or not torch.is_grad_enabled():
        return p.wq, p.wk, p.wv
    axes = ctx.physical_axes("tp")
    lays = [head_layout(cfg, tp, i) for i in range(tp)]
    q_keys, kv_keys = [lay.q0 for lay in lays], [lay.kv0 for lay in lays]
    return (ctx.fan_out(p.wq, axes, q_keys), ctx.fan_out(p.wk, axes, kv_keys),
            ctx.fan_out(p.wv, axes, kv_keys))


def flat_projections() -> bool:
    """Whether the active rules cut the projections by flat column
    blocks: a tensor-parallel dim over more than one mesh axis, the 2-D
    decode layout (``launch.mesh.serve_decode_param_rules``), which only
    :func:`mha_decode` runs."""
    return len(ctx.physical_axes("tp")) > 1


def projection_columns(cfg: ModelConfig, tp: int, index: int) -> dict[str, tuple[int, int]]:
    """Rank ``index`` of ``tp``'s ``(start, stop)`` of the flat columns of
    ``wq`` (``H * dh``), ``wk`` and ``wv`` (``Kv * dh``) and of the rows of
    ``wo``: its heads' (:func:`head_layout`), or under
    :func:`flat_projections` an even block of each, GSPMD's cut (a head
    split between ranks; ``ValueError`` where the ranks do not divide a
    width)."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if flat_projections():
        out = {}
        for leaf, width in (("wq", h * dh), ("wk", kv * dh), ("wv", kv * dh), ("wo", h * dh)):
            if width % tp:
                raise ValueError(f"{cfg.name}: {leaf}'s {width} columns do not split over "
                                 f"{tp} ranks")
            out[leaf] = (index * width // tp, (index + 1) * width // tp)
        return out
    lay = head_layout(cfg, tp, index)
    kv_cols = (lay.kv0 * dh, (lay.kv0 + lay.kv_heads) * dh)
    return {"wq": (lay.q0 * dh, (lay.q0 + lay.heads) * dh), "wk": kv_cols, "wv": kv_cols,
            "wo": (lay.wo0, lay.wo0 + lay.wo_rows)}


def _whole_columns(cfg: ModelConfig, y: torch.Tensor, leaf: str) -> torch.Tensor:
    """``y`` (..., this rank's columns of ``leaf``'s product) as the whole
    product every rank then holds: gathered over ``tp`` and, where ranks
    hold the same heads, each column taken from the first rank that holds
    it."""
    n = ctx.axis_size("tp")
    if n == 1:
        return y
    w = y.shape[-1]
    parts = ctx.all_gather(y[None], ctx.physical_axes("tp"), 0, adjoint="slice")
    parts = parts.movedim(0, -2).reshape(*y.shape[:-1], n * w)
    cols = tuple(projection_columns(cfg, n, j)[leaf] for j in range(n))
    if cols == tuple((j * w, (j + 1) * w) for j in range(n)):
        return parts
    return parts.index_select(-1, _first_holders(cols, w).to(y.device))


@functools.lru_cache(maxsize=64)
def _first_holders(cols: tuple[tuple[int, int], ...], w: int) -> torch.Tensor:
    """For each column of the whole product, its place among the
    gathered ranks' ``w`` columns each, from the first rank holding it."""
    src = torch.empty(max(stop for _, stop in cols), dtype=torch.int64)
    for j in reversed(range(len(cols))):
        start, stop = cols[j]
        src[start:stop] = torch.arange(j * w, (j + 1) * w)
    return src


def _project_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``out`` (..., heads * dh) through this rank's rows of ``wo``, summed
    over ``model``: where a head's ranks split its rows, each takes its
    part of the head's output columns."""
    width, tp = wo.shape[0], ctx.physical_axes("tp")
    if width < out.shape[-1]:
        part = ctx.axis_index(tp) % (out.shape[-1] // width)
        out = out[..., part * width : (part + 1) * width]
    return ctx.matmul_psum(out, wo, tp)


def mha(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (S,) absolute positions
    *,
    kind: str = "full",  # full | swa
    causal: bool = True,
    use_rope: bool = True,
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,  # cross-attention
) -> torch.Tensor:
    """Full multi-head attention layer (projections + K1 core) over this
    rank's heads (all of them with no mesh)."""
    if flat_projections():
        raise ValueError("2-D tensor parallelism cuts heads apart: it serves decode alone")
    B, S, _ = x.shape
    dh = cfg.head_dim
    h, kv = p.wq.shape[1] // dh, p.wk.shape[1] // dh
    wq, wk, wv = held_projections(cfg, p)
    x = ctx.fan_out(x, ctx.physical_axes("tp"))
    q = (x @ wq).reshape(B, S, h, dh)
    if kv_override is None:
        k = (x @ wk).reshape(B, S, kv, dh)
        v = (x @ wv).reshape(B, S, kv, dh)
        if use_rope:
            q = rope(q, positions[None], cfg.rope_theta)
            k = rope(k, positions[None], cfg.rope_theta)
    else:
        k, v = kv_override
    out = mha_flash(
        q, k, v,
        causal=causal,
        window=cfg.sliding_window if kind == "swa" else 0,
        logit_cap=cfg.attn_logit_softcap,
    )
    return _project_out(out.reshape(B, S, h * dh), p.wo)


def cross_heads(
    cfg: ModelConfig, p: Attention, enc_out: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K and V for the rank's heads (all of them with
    no mesh), every frame: a forward's cross-attention over this rank's
    rows."""
    B, S, _ = enc_out.shape
    dh = cfg.head_dim
    kv = p.wk.shape[1] // dh
    _, wk, wv = held_projections(cfg, p)
    enc_out = ctx.fan_out(enc_out, ctx.physical_axes("tp"))
    k = (enc_out @ wk).reshape(B, S, kv, dh)
    v = (enc_out @ wv).reshape(B, S, kv, dh)
    return k, v


def cross_kv(
    cfg: ModelConfig, p: Attention, enc_out: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project the encoder output (B, S_enc, D) once for a decode cross
    cache, reused by every decode step: ``(k, v)`` of (B, S_enc, Kv, dh)
    with no mesh; under one this rank's part of the cache (an
    :class:`KVCache` of ``S_enc`` slots, ``model.init_cache``): its rows
    over ``cache_batch`` and its block of frames over ``cache_seq``, all
    KV heads."""
    B, S, _ = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    start, size = ctx.tile(S, ctx.physical_axes("cache_seq"))
    rows = ctx.physical_axes("cache_batch")

    def part(w, leaf):
        # the ranks of a product gather its columns of the same rows and
        # frames (every one: they hold other blocks), then take their own
        y = ctx.local_rows(_whole_columns(cfg, enc_out @ w, leaf), rows)
        return (y if size == S else y.narrow(1, start, size)).reshape(y.shape[0], size, kv, dh)

    return part(p.wk, "wk"), part(p.wv, "wv")


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """An attention layer's decode cache: ``k`` and ``v`` of (rows,
    slots, Kv, dh), a ring buffer of window size for SWA.  Under a mesh
    they hold this rank's rows and block of ``length`` slots (the whole
    cache's; ``None`` where the tensors hold every slot)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int | None = None

    @property
    def slots(self) -> int:
        """The whole cache's slots."""
        return self.k.shape[1] if self.length is None else self.length


def init_kv_cache(
    cfg: ModelConfig, batch: int, seq_len: int, *, kind: str, dtype: torch.dtype, device
) -> KVCache:
    """A zeroed cache; an SWA layer keeps at most ``sliding_window``
    slots."""
    size = min(seq_len, cfg.sliding_window) if kind == "swa" else seq_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def _ranks(axes: tuple[str, ...]) -> int:
    mesh = ctx.current_mesh()
    return 1 if mesh is None else mesh.axes_size(axes)


def _cache_row_axes() -> tuple[str, ...]:
    """The ``cache_batch`` axes that cut the cache's rows within the
    rows the activations hold (those a 2-D tensor-parallel product spans;
    none otherwise)."""
    mesh = ctx.current_mesh()
    if mesh is None:
        return ()
    rows, cache_rows = ctx.batch_axes(), ctx.physical_axes("cache_batch")
    if not {a for a in rows if mesh.shape[a] > 1} <= set(cache_rows):
        raise ValueError(f"decode rows over {rows} but cache rows over {cache_rows}: "
                         "decode under a mesh takes a decode cell's rules")
    return tuple(a for a in cache_rows if a not in rows)


def _softmax(logits: torch.Tensor, seq: tuple[str, ...]) -> torch.Tensor:
    """The softmax over the last dim, whose entries lie over the ``seq``
    ranks: a rank's row maximum (``_NEG_INF`` for an empty block) taken
    over the ranks, its exponentials, and their sums added over the
    ranks; ``torch.softmax`` over one rank."""
    if _ranks(seq) == 1:
        return torch.softmax(logits, dim=-1)
    if logits.shape[-1]:
        m = logits.amax(dim=-1)
    else:
        m = logits.new_full(logits.shape[:-1], _NEG_INF)
    e = torch.exp(logits - ctx.pmax(m, seq)[..., None])
    return e / ctx.psum(e.sum(dim=-1), seq)[..., None]


def mha_decode(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,  # (B, 1, D)
    cache: KVCache,
    pos: int,  # index of the new token
    *,
    kind: str = "full",
    use_rope: bool = True,
    cross: bool = False,  # attend a static cross cache; no update, no mask
) -> tuple[torch.Tensor, KVCache]:
    """Attention of one new token per sequence; writes its K/V into
    ``cache`` in place (slot ``pos``, or ``pos % window`` in an SWA ring;
    under a mesh the rank whose block holds the slot) and returns ``(out
    (B, 1, D), cache)``."""
    B = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = h // kv
    S = cache.slots
    windowed = kind == "swa" and S == cfg.sliding_window
    at = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    seq, tp = ctx.physical_axes("cache_seq"), ctx.physical_axes("tp")
    start, size = ctx.tile(S, seq)
    if cache.k.shape[1] != size:
        raise ValueError(f"a cache block of {cache.k.shape[1]} slots where the layout "
                         f"gives {size} of {S}")
    rows = _cache_row_axes()

    q = _whole_columns(cfg, x @ p.wq, "wq").reshape(B, h, dh)
    if use_rope and not cross:
        q = rope(q[:, None], at, cfg.rope_theta)[:, 0]
    q = ctx.local_rows(q, rows)

    valid = None
    if not cross:
        k_new = _whole_columns(cfg, x @ p.wk, "wk").reshape(B, 1, kv, dh)
        v_new = _whole_columns(cfg, x @ p.wv, "wv").reshape(B, 1, kv, dh)
        if use_rope:
            k_new = rope(k_new, at, cfg.rope_theta)
        slot = pos % S if windowed else min(pos, S - 1)
        if start <= slot < start + size:  # this rank's block holds the slot
            cache.k[:, slot - start] = ctx.local_rows(k_new[:, 0], rows).to(cache.k.dtype)
            cache.v[:, slot - start] = ctx.local_rows(v_new[:, 0], rows).to(cache.v.dtype)
        idx = torch.arange(start, start + size, device=x.device)
        valid = idx < min(pos + 1, S) if windowed else idx <= pos

    k, v = cache.k, cache.v
    qg = q.reshape(q.shape[0], kv, G, dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * (dh**-0.5)
    if cfg.attn_logit_softcap > 0.0:
        logits = softcap(logits, cfg.attn_logit_softcap)
    if valid is not None:
        logits = torch.where(valid, logits, _NEG_INF)
    w = _softmax(logits, seq)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(v.dtype).float(), v.float())
    out = ctx.psum(out, seq).to(x.dtype).reshape(-1, 1, h * dh)
    out = ctx.all_gather(out, rows, 0, adjoint="slice")
    wo0, wo1 = projection_columns(cfg, ctx.axis_size("tp"), ctx.axis_index(tp))["wo"]
    if wo1 - wo0 != out.shape[-1]:
        out = out[..., wo0:wo1]
    return ctx.matmul_psum(out, p.wo, tp), cache
