"""The ``ssm`` family: a mamba-1 mixer and no FFN in every layer
(falcon-mamba-7b).  Leaves are named as the program names them."""

from __future__ import annotations

import math

from portbench import work as W

# leaves served in float32 besides the norm scales: the SSM's dynamics
FLOAT32_SERVED = ("A_log", "D", "dt_bias")


def d_inner(cfg: dict) -> int:
    return cfg.get("ssm_expand", 2) * cfg["d_model"]


def dt_rank(cfg: dict) -> int:
    return cfg.get("dt_rank") or -(-cfg["d_model"] // 16)


def layout(cfg: dict) -> list[tuple[str, tuple[int, ...], tuple]]:
    """``(name, shape, init)`` of every leaf; ``init`` is ``("normal",
    scale)``, ``("fill", value)`` or ``("log_arange",)`` (``log(1..N)`` in
    every row)."""
    d, n, K = cfg["d_model"], cfg["ssm_state"], cfg["ssm_conv"]
    di, r, vocab = d_inner(cfg), dt_rank(cfg), W.padded_vocab(cfg)
    leaves = [("embed.table", (vocab, d), ("normal", 0.02))]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        m = p + "mixer."
        leaves += [
            (p + "norm1", (d,), ("fill", 0.0)),
            (m + "in_proj", (d, 2 * di), ("normal", d**-0.5)),
            (m + "conv_w", (K, di), ("normal", K**-0.5)),
            (m + "conv_b", (di,), ("fill", 0.0)),
            (m + "x_proj", (di, r + 2 * n), ("normal", di**-0.5)),
            (m + "dt_proj", (r, di), ("normal", r**-0.5)),
            (m + "dt_bias", (di,), ("fill", math.log(math.expm1(0.01)))),  # softplus -> 0.01
            (m + "A_log", (di, n), ("log_arange",)),
            (m + "D", (di,), ("fill", 1.0)),
            (m + "out_proj", (di, d), ("normal", di**-0.5)),
        ]
    leaves += [("final_norm", (d,), ("fill", 0.0)), ("lm_head", (d, vocab), ("normal", 0.02))]
    return leaves


def products(cfg: dict) -> list[tuple[str, int, int]]:
    """``(name, k, n)`` of each product one layer applies to every token:
    the mixer's four projections (its depthwise conv is no product)."""
    d, di, n, r = cfg["d_model"], d_inner(cfg), cfg["ssm_state"], dt_rank(cfg)
    return [("in_proj", d, 2 * di), ("x_proj", di, r + 2 * n), ("dt_proj", r, di),
            ("out_proj", di, d)]


def prefill_kernels(cfg: dict, B: int, S: int) -> dict[str, list]:
    """K2's forward once a layer."""
    return {"k2": [W.scan_fwd(B, S, d_inner(cfg), cfg["ssm_state"])] * cfg["n_layers"]}


def train_kernels(cfg: dict, micro: int, S: int) -> dict[str, list]:
    """K2's forward and backward once a layer, for one micro-batch; the
    recompute's second forward is not work."""
    pair = [W.scan_fwd(micro, S, d_inner(cfg), cfg["ssm_state"]),
            W.scan_bwd(micro, S, d_inner(cfg), cfg["ssm_state"])]
    return {"k2": pair * cfg["n_layers"]}


def build(mcfg, t: dict):
    """The program's model over the tensors ``t`` (shared, not copied)."""
    from repro_torch.models import model as M
    from repro_torch.models.mamba import Mamba

    layers = []
    for i in range(mcfg.n_layers):
        m = f"layers.{i}.mixer."
        mixer = Mamba(*(t[m + k] for k in Mamba.LEAVES))
        layers.append(M.Block(t[f"layers.{i}.norm1"], mixer))
    return M.LM(t["embed.table"], layers, t["final_norm"], t["lm_head"])
