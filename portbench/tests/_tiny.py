"""Tiny configurations of the two families and tiny mixes, for the CPU."""

from __future__ import annotations

import time

import torch

from portbench import traffic as T
from portbench import weights
from portbench.cells.common import Cell, model_config  # noqa: F401  (the tests' too)

DTYPES = dict(param_dtype="float32", compute_dtype="bfloat16", moment_dtype="float32",
              norm_eps=1e-5, tie_embeddings=False)
DENSE = dict(name="tiny-dense", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab_size=512, attn_pattern="swa", sliding_window=24, rope_theta=10000.0,
             **DTYPES)
SSM = dict(name="tiny-ssm", family="ssm", n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
           vocab_size=512, attn_pattern="none", ssm_state=8, ssm_conv=4, ssm_expand=2, dt_rank=0,
           **DTYPES)
CONFIGS = {"dense": DENSE, "ssm": SSM}
TRAIN = dict(T.load("train_4k"), seq_len=40, micro_batch=2, accum=2)
PREFILL = dict(T.load("prefill_mix_1k_8k"), deck=[[16, 2], [48, 1], [64, 1]])
TRAIN_LIMITS = {"check_steps": 3,
                "numbers": {k: {"limit": 0.05} for k in ("loss_gap", "grad_gap", "update_gap")}}
PREFILL_LIMITS = {"check_requests": 3,
                  "numbers": {"logit_err": {"limit": 0.1}, "greedy_gap": {"limit": 0.2}}}


def leaves(family, cfg: dict, dtype=torch.float32, seed: int = 0) -> dict:
    return weights.make(family.layout(cfg), torch.Generator().manual_seed(seed),
                        lambda _: dtype, "cpu")


def cell(cfg: dict, kind: str, seed: int = 2**31 + 7, seconds: float = 0.5) -> Cell:
    traffic, limits = (TRAIN, TRAIN_LIMITS) if kind == "train" else (PREFILL, PREFILL_LIMITS)
    return Cell(f"tiny_{kind}", cfg, traffic, limits, seed, seconds, False, "cpu",
                time.perf_counter())
