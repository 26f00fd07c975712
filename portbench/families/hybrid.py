"""The ``hybrid`` family: attention and mamba-1 mixers in periods, a dense
SwiGLU or a dropless top-k MoE after each (AI21-Jamba2-Mini).  Which
layer has which mixer and FFN is read from the published config's own
keys (as ``reference/hybrid.py`` reads them); ``build`` asks the program
for its kinds, so a program that placed them otherwise finds no leaves.
Leaves are named as the program names them.

The work of a prefill: ``prefill_kernels`` returns the whole ``"gemm"``
list, which replaces the one ``work.prefill_work`` makes from
``products`` (its dict merge lets a family's list win).  That list holds
each layer's own products: attention's four, the mixer's four, the dense
FFN's three; per MoE layer the router (float32, at the float32 peak) and
the experts' three grouped products, each with the operations of k
choices a token and the bytes of every expert's weights read once; and
the head at the last position.  Its operations are the stage's model
operations exactly, and its bytes are those of the real weights (the
mean layer of ``products`` would count one expert's weights a product
where the stage reads sixteen).  ``products`` is the stage's mean layer,
for ``work.train_work``: each product's ``n`` scaled by the share of the
layers that apply it, and by k for the experts.
"""

from __future__ import annotations

import math
from fractions import Fraction

from portbench import work as W
from portbench.reference.hybrid import ffn_kind, mixer_kind

# leaves served in float32 besides the norm scales: the router (its
# logits and softmax are float32) and the SSM's dynamics
FLOAT32_SERVED = ("router", "A_log", "D", "dt_bias")


def _sizes(cfg: dict) -> dict:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(d=d, H=H, kv=cfg["num_key_value_heads"], dh=d // H,
                f=cfg["intermediate_size"], di=cfg["mamba_expand"] * d,
                n=cfg["mamba_d_state"], r=cfg["mamba_dt_rank"], K=cfg["mamba_d_conv"],
                E=cfg["num_experts"], k=cfg["num_experts_per_tok"])


def layout(cfg: dict) -> list[tuple[str, tuple[int, ...], tuple]]:
    """``(name, shape, init)`` of every leaf; ``init`` is ``("normal",
    scale)``, ``("fill", value)`` or ``("log_arange",)``."""
    s = _sizes(cfg)
    d, f, di, n, r, E = s["d"], s["f"], s["di"], s["n"], s["r"], s["E"]
    hd, kvd = s["H"] * s["dh"], s["kv"] * s["dh"]
    leaves = [("embed.table", (W.padded_vocab(cfg), d), ("normal", 0.02))]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        m = p + "mixer."
        leaves.append((p + "norm1", (d,), ("fill", 0.0)))
        if mixer_kind(cfg, i) == "attn":
            leaves += [(m + "wq", (d, hd), ("normal", d**-0.5)),
                       (m + "wk", (d, kvd), ("normal", d**-0.5)),
                       (m + "wv", (d, kvd), ("normal", d**-0.5)),
                       (m + "wo", (hd, d), ("normal", hd**-0.5))]
        else:
            leaves += [(m + "in_proj", (d, 2 * di), ("normal", d**-0.5)),
                       (m + "conv_w", (s["K"], di), ("normal", s["K"] ** -0.5)),
                       (m + "conv_b", (di,), ("fill", 0.0)),
                       (m + "x_proj", (di, r + 2 * n), ("normal", di**-0.5)),
                       (m + "dt_proj", (r, di), ("normal", r**-0.5)),
                       (m + "dt_bias", (di,), ("fill", math.log(math.expm1(0.01)))),
                       (m + "A_log", (di, n), ("log_arange",)),
                       (m + "D", (di,), ("fill", 1.0)),
                       (m + "out_proj", (di, d), ("normal", di**-0.5)),
                       (m + "dt_norm", (r,), ("fill", 0.0)),
                       (m + "b_norm", (n,), ("fill", 0.0)),
                       (m + "c_norm", (n,), ("fill", 0.0))]
        leaves.append((p + "norm2", (d,), ("fill", 0.0)))
        q = p + "ffn."
        if ffn_kind(cfg, i) == "moe":
            leaves += [(q + "router", (d, E), ("normal", d**-0.5)),
                       (q + "w_gate", (E, d, f), ("normal", d**-0.5)),
                       (q + "w_up", (E, d, f), ("normal", d**-0.5)),
                       (q + "w_down", (E, f, d), ("normal", f**-0.5))]
        else:
            leaves += [(q + "w_gate", (d, f), ("normal", d**-0.5)),
                       (q + "w_up", (d, f), ("normal", d**-0.5)),
                       (q + "w_down", (f, d), ("normal", f**-0.5))]
    leaves += [("final_norm", (d,), ("fill", 0.0)),
               ("lm_head", (d, W.padded_vocab(cfg)), ("normal", 0.02))]
    return leaves


def _layer_products(cfg: dict, i: int) -> list[tuple[str, int, int]]:
    """``(name, k, n)`` of layer ``i``'s dense products; an MoE layer's
    experts are :func:`expert_work`'s."""
    s = _sizes(cfg)
    d, f, di = s["d"], s["f"], s["di"]
    if mixer_kind(cfg, i) == "attn":
        hd, kvd = s["H"] * s["dh"], s["kv"] * s["dh"]
        out = [("wq", d, hd), ("wk", d, kvd), ("wv", d, kvd), ("wo", hd, d)]
    else:
        out = [("in_proj", d, 2 * di), ("x_proj", di, s["r"] + 2 * s["n"]),
               ("dt_proj", s["r"], di), ("out_proj", di, d)]
    if ffn_kind(cfg, i) == "dense":
        out += [("w_gate", d, f), ("w_up", d, f), ("w_down", f, d)]
    return out


def _moe_layers(cfg: dict) -> int:
    return sum(ffn_kind(cfg, i) == "moe" for i in range(cfg["n_layers"]))


def expert_work(cfg: dict, T: int) -> list[W.Work]:
    """The experts' three grouped products of one MoE layer over ``T``
    tokens: the operations of k choices a token, every expert's weights
    read once, the rows read and the outputs written once, bf16."""
    s = _sizes(cfg)
    d, f, E, rows = s["d"], s["f"], s["E"], s["k"] * T
    gate = W.Work(2.0 * rows * d * f, 2.0 * (rows * d + E * d * f + rows * f))
    down = W.Work(2.0 * rows * f * d, 2.0 * (rows * f + E * f * d + rows * d))
    return [gate, gate, down]


def products(cfg: dict) -> list[tuple[str, int, int]]:
    """The stage's mean layer: ``(name, k, n)`` of each product, ``n``
    scaled by the share of the layers that apply it (and by k for the
    experts), so ``n_layers`` of them hold the stage's operations."""
    L, s = cfg["n_layers"], _sizes(cfg)
    share: dict[tuple[str, int, int], Fraction] = {}
    for i in range(L):
        for p in _layer_products(cfg, i):
            share[p] = share.get(p, Fraction(0)) + Fraction(1, L)
    moe = Fraction(_moe_layers(cfg), L)
    d, f = s["d"], s["f"]
    for p, times in ((("router", d, s["E"]), 1), (("expert_gate", d, f), s["k"]),
                     (("expert_up", d, f), s["k"]), (("expert_down", f, d), s["k"])):
        share[p] = moe * times
    out = []
    for (name, k, n), frac in share.items():
        scaled = n * frac
        if scaled.denominator != 1:
            raise ValueError(f"{name}: {n} x {frac} is no whole width")
        out.append((name, k, int(scaled)))
    return out


def prefill_kernels(cfg: dict, B: int, S: int) -> dict[str, list]:
    """The whole ``"gemm"`` list (module docstring), K1's forward once an
    attention layer (full causal, no log-sum-exp) and K2's forward once a
    mamba layer."""
    s, m = _sizes(cfg), B * S
    gemms, k1, k2 = [], [], []
    for i in range(cfg["n_layers"]):
        gemms += [W.gemm(m, k, n) for _, k, n in _layer_products(cfg, i)]
        if ffn_kind(cfg, i) == "moe":
            gemms.append(W.Work(2.0 * m * s["d"] * s["E"], 4.0 * (m * s["d"] + s["d"] * s["E"]
                                                                   + m * s["E"]), W.F32_OPS_PER_S))
            gemms += expert_work(cfg, m)
        if mixer_kind(cfg, i) == "attn":
            k1.append(W.flash_fwd(B, s["H"], s["kv"], S, S, s["dh"], window=0))
        else:
            k2.append(W.scan_fwd(B, S, s["di"], s["n"]))
    gemms.append(W.gemm(B, s["d"], W.padded_vocab(cfg)))
    return {"gemm": gemms, "k1": k1, "k2": k2}


def train_kernels(cfg: dict, micro: int, S: int) -> dict[str, list]:
    """K1's forward (keeping the log-sum-exp) and backward once an
    attention layer, K2's forward and backward once a mamba layer, for
    one micro-batch; the recompute's second forward is not work."""
    s = _sizes(cfg)
    shape = (micro, s["H"], s["kv"], S, S, s["dh"])
    out = {"k1": [], "k2": []}
    for i in range(cfg["n_layers"]):
        if mixer_kind(cfg, i) == "attn":
            out["k1"] += [W.flash_fwd(*shape, window=0, lse=True), W.flash_bwd(*shape, window=0)]
        else:
            out["k2"] += [W.scan_fwd(micro, S, s["di"], s["n"]),
                          W.scan_bwd(micro, S, s["di"], s["n"])]
    return out


def build(mcfg, t: dict):
    """The program's model over the tensors ``t`` (shared, not copied),
    each layer's mixer and FFN of the kinds the program gives its slot."""
    from repro_torch.models import model as M
    from repro_torch.models.attention import Attention
    from repro_torch.models.layers import SwiGLU
    from repro_torch.models.mamba import Mamba
    from repro_torch.models.moe import MoE

    layers = []
    for i in range(mcfg.n_layers):
        p = f"layers.{i}."
        mixer_kind, _, ffn_kind_ = M.slot_kinds(mcfg, i % mcfg.group_size)
        if mixer_kind == "attn":
            mixer = Attention(*(t[p + "mixer." + k] for k in ("wq", "wk", "wv", "wo")))
        else:
            mixer = Mamba(*(t[p + "mixer." + k] for k in Mamba.LEAVES + Mamba.NORMS))
        leaves = (MoE.LEAVES if ffn_kind_ == "moe" else ("w_gate", "w_up", "w_down"))
        ffn = (MoE if ffn_kind_ == "moe" else SwiGLU)(*(t[p + "ffn." + k] for k in leaves))
        layers.append(M.Block(t[p + "norm1"], mixer, t[p + "norm2"], ffn))
    return M.LM(t["embed.table"], layers, t["final_norm"], t["lm_head"])
