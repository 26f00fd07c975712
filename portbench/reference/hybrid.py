"""A layer of the ``hybrid`` family (AI21-Jamba2-Mini: transformers'
``modeling_jamba.py``), float32, from the published equations and read
from the published config's own keys:

* layer ``i``'s mixer is attention where ``i % attn_layer_period ==
  attn_layer_offset``, else a mamba-1 mixer; its FFN is an MoE where
  ``i % expert_layer_period == expert_layer_offset``, else a dense SwiGLU
  of the same width;
* block: ``h = x + Mixer(RMSNorm(x))``, ``x' = h + FFN(RMSNorm(h))``;
* attention: grouped-query, full causal, **no positional encoding**;
* mamba: ``[xin, z] = h W_in``; ``xc = SiLU(conv4(xin) + conv_b)``;
  ``[dt, B, C] = xc W_x``, each RMS-normalised over its own width
  (``dt_layernorm``, ``b_layernorm``, ``c_layernorm``);
  ``dt = softplus(dt W_dt + dt_bias)``; ``s_t = exp(dt_t A) s_{t-1} +
  dt_t xc_t B_t``, ``y_t = s_t . C_t + D xc_t``; out ``(y * SiLU(z))
  W_out``.  The scan is ``reference/ssm.py``'s;
* MoE: ``p = softmax(h W_r)`` over all 16 experts in float32, the top 2
  by ``p`` **not renormalised** (``JambaSparseMoeBlock``), no capacity:
  ``out = sum_{j in top2} p_j (SiLU(h W_g^j) * h W_u^j) W_d^j``.

Departures from the published model, each shared with the program: the
norm scales are ``(1 + w)`` with ``w`` drawn at 0 (the repository's
convention; the published ``weight`` starts at 1, the same function);
random weights from the seed.  The experts are upcast to float32 one at
a time, each over the tokens that chose it, so 52 GB of bf16 weights and
the float32 work fit one card.

Forced routing (:func:`routing`): inside it, MoE layer ``j`` (counted in
the order the layers run) takes ``forced[j]`` (T, 2) as its choices
instead of its own top 2, with its own float32 probabilities of them;
every MoE layer's float32 router logits and the choices it took are
kept, so a caller can tell how near a tie the reference's own choices
were where the program's differ (:func:`route_margin`).  For the fault a
limit is set from, ``router="bf16"`` takes the router's product with
bf16 operands and a bf16 result.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from portbench.reference import common as C
from portbench.reference import ssm

# leaves AdamW does not decay besides the norm scales: the SSM's dynamics
# and the conv's bias
NO_DECAY = ssm.NO_DECAY


class Routes(NamedTuple):
    logits: list  # each MoE layer's float32 router logits (T, E), in the order the layers run
    chosen: list  # the choices (T, k) each took


_ROUTING: dict = {"forced": None, "router": "float32", "routes": None}


@contextlib.contextmanager
def routing(forced: list[torch.Tensor] | None = None, router: str = "float32"):
    """Inside, MoE layer ``j`` takes ``forced[j]`` (T, k) as its choices
    (its own top k where ``forced`` is ``None``) and computes its router
    in ``router`` (``"float32"``, or ``"bf16"`` for the fault); yields the
    :class:`Routes` the MoE layers append to."""
    prev = dict(_ROUTING)
    _ROUTING.update(forced=None if forced is None else list(forced), router=router,
                    routes=Routes([], []))
    try:
        yield _ROUTING["routes"]
    finally:
        _ROUTING.update(prev)


def route_margin(logits: list[torch.Tensor], chosen: list[torch.Tensor], k: int = 2) -> float:
    """The widest gap in router logits between the reference's own k-th
    and (k+1)-th choice, over the (token, layer) pairs where its own top
    k (as a set) differs from ``chosen``'s; 0 where none differs."""
    widest = 0.0
    for lg, ch in zip(logits, chosen, strict=True):
        top = torch.topk(lg, k + 1, dim=-1)
        own = torch.sort(top.indices[:, :k], dim=-1).values
        differs = (own != torch.sort(ch.to(own.device), dim=-1).values).any(-1)
        if bool(differs.any()):
            gap = top.values[:, k - 1] - top.values[:, k]
            widest = max(widest, float(gap[differs].max()))
    return widest


def mixer_kind(cfg: dict, i: int) -> str:
    return "attn" if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"] else "mamba"


def ffn_kind(cfg: dict, i: int) -> str:
    return "moe" if i % cfg["expert_layer_period"] == cfg["expert_layer_offset"] else "dense"


def _attention(cfg: dict, w: dict, p: str, h: torch.Tensor, precision: str) -> torch.Tensor:
    B, S, _ = h.shape
    H, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["hidden_size"] // H
    q = C.mm(h, w[p + "wq"], precision).view(B, S, H, dh)
    k = C.mm(h, w[p + "wk"], precision).view(B, S, kv, dh)
    v = C.mm(h, w[p + "wv"], precision).view(B, S, kv, dh)
    o = C.attention(q, k, v, 0, precision).reshape(B, S, H * dh)
    return C.mm(o, w[p + "wo"], precision)


def _mamba(cfg: dict, w: dict, p: str, h: torch.Tensor, precision: str) -> torch.Tensor:
    """Under the control every activation the program holds in its compute
    dtype is rounded too, as in ``reference/ssm.py``."""
    n, r, eps = cfg["mamba_d_state"], cfg["mamba_dt_rank"], cfg["rms_norm_eps"]

    def held(t):
        return C.rounded(t, precision)

    xin, z = (held(t) for t in C.mm(h, w[p + "in_proj"], precision).chunk(2, dim=-1))
    K = w[p + "conv_w"].shape[0]
    xp = F.pad(xin, (0, 0, K - 1, 0))  # K-1 zeros before the first step
    conv = w[p + "conv_b"].float() + sum(
        w[p + "conv_w"][j].float() * xp[:, j:j + xin.shape[1]] for j in range(K))
    xc = held(C.silu(held(conv)))
    dt, Bm, Cm = (held(t) for t in C.mm(xc, w[p + "x_proj"], precision).split([r, n, n], -1))
    dt = held(C.rms_norm(dt, w[p + "dt_norm"], eps))
    Bm, Cm = C.rms_norm(Bm, w[p + "b_norm"], eps), C.rms_norm(Cm, w[p + "c_norm"], eps)
    dt = held(F.softplus(C.mm(dt, w[p + "dt_proj"], precision) + w[p + "dt_bias"].float()))
    A = -torch.exp(w[p + "A_log"].float())
    y = ssm.scan(dt, A, Bm, Cm, xc)
    y = (y + xc * w[p + "D"].float()) * C.silu(z)
    return C.mm(y, w[p + "out_proj"], precision)


def _swiglu(h, wg, wu, wd, precision):
    return C.mm(C.silu(C.mm(h, wg, precision)) * C.mm(h, wu, precision), wd, precision)


def _moe(cfg: dict, w: dict, p: str, h: torch.Tensor, precision: str) -> torch.Tensor:
    B, S, d = h.shape
    k = cfg["num_experts_per_tok"]
    x = h.reshape(B * S, d)
    if _ROUTING["router"] == "bf16":
        logits = (x.bfloat16() @ w[p + "router"].bfloat16()).float()
    else:
        logits = C.mm(x, w[p + "router"], precision)  # (T, E) float32
    probs = torch.softmax(logits, dim=-1)
    forced = _ROUTING["forced"]
    chosen = forced.pop(0).to(x.device) if forced is not None else torch.topk(probs, k, -1).indices
    if _ROUTING["routes"] is not None:
        _ROUTING["routes"].logits.append(logits)
        _ROUTING["routes"].chosen.append(chosen)
    out = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        rows = (chosen == e).any(-1).nonzero()[:, 0]
        if rows.numel():
            y = _swiglu(x[rows], w[p + "w_gate"][e], w[p + "w_up"][e], w[p + "w_down"][e],
                        precision)
            out.index_add_(0, rows, y * probs[rows, e, None])
    return out.view(B, S, d)


def layer(cfg: dict, w: dict, i: int, x: torch.Tensor, precision: str) -> torch.Tensor:
    p = f"layers.{i}."
    eps = cfg["rms_norm_eps"]
    h = C.rms_norm(x, w[p + "norm1"], eps)
    mix = _attention if mixer_kind(cfg, i) == "attn" else _mamba
    x = x + mix(cfg, w, p + "mixer.", h, precision)
    h = C.rms_norm(x, w[p + "norm2"], eps)
    if ffn_kind(cfg, i) == "moe":
        return x + _moe(cfg, w, p + "ffn.", h, precision)
    return x + _swiglu(h, w[p + "ffn.w_gate"], w[p + "ffn.w_up"], w[p + "ffn.w_down"], precision)
