"""The ``dense`` family: attention and a SwiGLU FFN in every layer
(h2o-danube-1.8b).  Leaves are named as the program names them."""

from __future__ import annotations

from portbench import work as W

# leaves served in float32 besides the norm scales
FLOAT32_SERVED = ()


def head_dim(cfg: dict) -> int:
    return cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]


def window(cfg: dict) -> int:
    return cfg.get("sliding_window", 0) if cfg.get("attn_pattern") == "swa" else 0


def layout(cfg: dict) -> list[tuple[str, tuple[int, ...], tuple]]:
    """``(name, shape, init)`` of every leaf; ``init`` is ``("normal",
    scale)`` or ``("fill", value)``."""
    d, H, kv, f = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    dh, vocab = head_dim(cfg), W.padded_vocab(cfg)
    leaves = [("embed.table", (vocab, d), ("normal", 0.02))]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        leaves += [
            (p + "norm1", (d,), ("fill", 0.0)),
            (p + "mixer.wq", (d, H * dh), ("normal", d**-0.5)),
            (p + "mixer.wk", (d, kv * dh), ("normal", d**-0.5)),
            (p + "mixer.wv", (d, kv * dh), ("normal", d**-0.5)),
            (p + "mixer.wo", (H * dh, d), ("normal", (H * dh) ** -0.5)),
            (p + "norm2", (d,), ("fill", 0.0)),
            (p + "ffn.w_gate", (d, f), ("normal", d**-0.5)),
            (p + "ffn.w_up", (d, f), ("normal", d**-0.5)),
            (p + "ffn.w_down", (f, d), ("normal", f**-0.5)),
        ]
    leaves += [("final_norm", (d,), ("fill", 0.0)), ("lm_head", (d, vocab), ("normal", 0.02))]
    return leaves


def products(cfg: dict) -> list[tuple[str, int, int]]:
    """``(name, k, n)`` of each product one layer applies to every token:
    attention's four projections and the SwiGLU FFN's three."""
    d, h, kv, dh, f = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg), cfg["d_ff"]
    return [("wq", d, h * dh), ("wk", d, kv * dh), ("wv", d, kv * dh), ("wo", h * dh, d),
            ("w_gate", d, f), ("w_up", d, f), ("w_down", f, d)]


def prefill_kernels(cfg: dict, B: int, S: int) -> dict[str, list]:
    """K1's forward once a layer (no log-sum-exp kept)."""
    fwd = W.flash_fwd(B, cfg["n_heads"], cfg["n_kv_heads"], S, S, head_dim(cfg),
                      window=window(cfg))
    return {"k1": [fwd] * cfg["n_layers"]}


def train_kernels(cfg: dict, micro: int, S: int) -> dict[str, list]:
    """K1's forward (keeping the log-sum-exp) and backward once a layer,
    for one micro-batch; the recompute's second forward is not work."""
    shape = (micro, cfg["n_heads"], cfg["n_kv_heads"], S, S, head_dim(cfg))
    pair = [W.flash_fwd(*shape, window=window(cfg), lse=True),
            W.flash_bwd(*shape, window=window(cfg))]
    return {"k1": pair * cfg["n_layers"]}


def build(mcfg, t: dict):
    """The program's model over the tensors ``t`` (shared, not copied)."""
    from repro_torch.models import model as M
    from repro_torch.models.attention import Attention
    from repro_torch.models.layers import SwiGLU

    layers = []
    for i in range(mcfg.n_layers):
        p = f"layers.{i}."
        mixer = Attention(*(t[p + "mixer." + k] for k in ("wq", "wk", "wv", "wo")))
        ffn = SwiGLU(*(t[p + "ffn." + k] for k in ("w_gate", "w_up", "w_down")))
        layers.append(M.Block(t[p + "norm1"], mixer, t[p + "norm2"], ffn))
    return M.LM(t["embed.table"], layers, t["final_norm"], t["lm_head"])
