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
  ``wo``; K1 and the decode cache run on those heads and the output
  projection's partial sums are added over ``model``.  The reference's
  decode cache is sequence-sharded instead (``cache_seq``); a head-sharded
  cache computes the same function (the sequence-sharded one waits for
  ROADMAP §1 P14c).  In training, where ranks hold the same KV heads
  (fewer than the ranks) or the same query head (its ranks splitting its
  rows of ``wo``), each uses them in part, so their gradients are added
  over exactly those ranks (:func:`held_projections`).
"""

from __future__ import annotations

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


def cross_kv(
    cfg: ModelConfig, p: Attention, enc_out: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project encoder output once; reused by every decode step."""
    B, S, _ = enc_out.shape
    dh = cfg.head_dim
    kv = p.wk.shape[1] // dh
    _, wk, wv = held_projections(cfg, p)
    enc_out = ctx.fan_out(enc_out, ctx.physical_axes("tp"))
    k = (enc_out @ wk).reshape(B, S, kv, dh)
    v = (enc_out @ wv).reshape(B, S, kv, dh)
    return k, v


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, Kv, dh) — ring buffer of size window for SWA
    v: torch.Tensor


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
    ``cache`` in place (slot ``pos``, or ``pos % window`` in an SWA ring)
    and returns ``(out (B, 1, D), cache)``."""
    B = x.shape[0]
    dh = cfg.head_dim
    h, kv = p.wq.shape[1] // dh, cache.k.shape[2]
    G = h // kv
    S = cache.k.shape[1]
    windowed = kind == "swa" and S == cfg.sliding_window
    at = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)

    q = (x @ p.wq).reshape(B, h, dh)
    if use_rope and not cross:
        q = rope(q[:, None], at, cfg.rope_theta)[:, 0]

    valid = None
    if not cross:
        k_new = (x @ p.wk).reshape(B, 1, kv, dh)
        v_new = (x @ p.wv).reshape(B, 1, kv, dh)
        if use_rope:
            k_new = rope(k_new, at, cfg.rope_theta)
        slot = pos % S if windowed else min(pos, S - 1)
        cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
        idx = torch.arange(S, device=x.device)
        valid = idx < min(pos + 1, S) if windowed else idx <= pos

    k, v = cache.k, cache.v
    qg = q.reshape(B, kv, G, dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * (dh**-0.5)
    if cfg.attn_logit_softcap > 0.0:
        logits = softcap(logits, cfg.attn_logit_softcap)
    if valid is not None:
        logits = torch.where(valid, logits, _NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(v.dtype).float(), v.float())
    out = _project_out(out.to(x.dtype).reshape(B, 1, h * dh), p.wo)
    return out, cache
