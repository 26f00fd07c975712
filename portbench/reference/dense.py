"""A decoder layer of the ``dense`` family (h2o-danube-1.8b: llama's block
with mistral's sliding window): RMSNorm, grouped-query attention with
rotary embeddings over a causal window of ``sliding_window`` keys, a
residual add, RMSNorm, a SwiGLU FFN, a residual add; float32."""

from __future__ import annotations

import torch

from portbench.reference import common as C

# leaves AdamW does not decay besides the norm scales
NO_DECAY = ()


def layer(cfg: dict, w: dict, i: int, x: torch.Tensor, precision: str) -> torch.Tensor:
    p = f"layers.{i}."
    B, S, _ = x.shape
    H, kv = cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg.get("d_head") or cfg["d_model"] // H
    window = cfg["sliding_window"] if cfg.get("attn_pattern") == "swa" else 0
    h = C.rms_norm(x, w[p + "norm1"], cfg["norm_eps"])
    q = C.rope(C.mm(h, w[p + "mixer.wq"], precision).view(B, S, H, dh), cfg["rope_theta"])
    k = C.rope(C.mm(h, w[p + "mixer.wk"], precision).view(B, S, kv, dh), cfg["rope_theta"])
    v = C.mm(h, w[p + "mixer.wv"], precision).view(B, S, kv, dh)
    o = C.attention(q, k, v, window, precision).reshape(B, S, H * dh)
    x = x + C.mm(o, w[p + "mixer.wo"], precision)
    h = C.rms_norm(x, w[p + "norm2"], cfg["norm_eps"])
    g = C.silu(C.mm(h, w[p + "ffn.w_gate"], precision)) * C.mm(h, w[p + "ffn.w_up"], precision)
    return x + C.mm(g, w[p + "ffn.w_down"], precision)
