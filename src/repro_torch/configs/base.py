"""Model/config system (port of ``repro.configs.base``), plain data.

One :class:`ModelConfig` covers every architecture family of the repo
(dense / MoE / SSM / hybrid / enc-dec / VLM) through block-pattern
fields; each ``repro_torch/configs/<arch>.py`` instantiates the published
configuration and registers it under its ``--arch`` id, with the same
values as the reference's file of that name.  ``reduced()`` gives the
tiny same-family configs the tests and the smoke run use.  Dtypes are
names (``"bfloat16"``); :func:`torch_dtype` maps them to torch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

# ---------------------------------------------------------------------------
# Shapes: seq_len x global_batch; decode/long lower serve_step.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"float32"``,
    ``"bfloat16"``)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-style (or enc-dec) transformer/SSM/hybrid model."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    d_head: int = 0  # derived from d_model/n_heads when 0

    # --- attention pattern ---
    attn_pattern: str = "full"  # full | swa | local_global | none
    sliding_window: int = 4_096
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    rotary: bool = True  # rotary embeddings in decoder self-attention (AI21-Jamba2-Mini: none)

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # MoE replaces the dense FFN every k-th layer
    capacity_factor: float = 1.25
    moe_impl: str = "gather"  # gather | a2a
    moe_renormalize: bool = True  # the top-k probabilities scaled to sum to 1
    moe_dropless: bool = False  # no capacity: every choice computed (one device only)

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0  # derived ceil(d_model/16) when 0
    ssm_inner_norms: bool = False  # RMSNorms of dt, B and C inside the mixer (jamba)
    attn_every: int = 0  # hybrid: attention mixer every k-th layer (jamba 1:7 -> 8)
    attn_offset: int = 0  # hybrid: the attention mixer's slot within those k

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    max_target_len: int = 448  # whisper decoder cap

    # --- modality frontend stubs ---
    frontend: str = "none"  # none | audio_frames | vit_patches
    frontend_tokens: int = 0  # number of patch embeddings prepended (vlm)

    # --- numerics / training ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- notes / skips ---
    long_context_ok: bool = False  # sub-quadratic: run long_500k
    notes: str = ""

    # ---------------- derived helpers ----------------

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's sharding
        pad; the padded rows are part of the parameter tree)."""
        return _round_up(self.vocab_size, 256)

    def mixer_kind(self, layer: int) -> str:
        """Which sequence mixer a layer uses."""
        if self.attn_pattern == "none":
            return "mamba"
        if self.attn_every:  # hybrid (jamba): attention every k-th layer
            return "attn" if layer % self.attn_every == self.attn_offset else "mamba"
        return "attn"

    def attn_kind(self, layer: int) -> str:
        """full | swa — per layer (gemma2 alternates local/global)."""
        if self.attn_pattern == "local_global":
            return "swa" if layer % 2 == 0 else "full"
        if self.attn_pattern == "swa":
            return "swa"
        return "full"

    def ffn_kind(self, layer: int) -> str:
        if self.n_experts and layer % self.moe_every == (self.moe_every - 1):
            return "moe"
        return "dense"

    @property
    def group_size(self) -> int:
        """Layer-pattern period: the stack repeats in groups of this many
        layers (hybrid / alternating patterns)."""
        period = 1
        if self.attn_every:
            period = self.attn_every
        if self.attn_pattern == "local_global":
            period = max(period, 2)
        if self.n_experts:
            period = _lcm(period, self.moe_every)
        if self.n_layers % period:
            raise ValueError(f"{self.name}: {self.n_layers} layers are not groups of {period}")
        return period

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.group_size

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    # ---------------- parameter counting ----------------

    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        total = self.padded_vocab * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.padded_vocab * self.d_model
        for layer in range(self.n_layers):
            total += self._layer_params(layer)
        if self.is_encoder_decoder:
            for _ in range(self.encoder_layers):
                total += self._attn_params() + self._dense_ffn_params() + 2 * self.d_model
            total += self.max_target_len * self.d_model  # decoder pos embed
            total += self.n_layers * (self._attn_params() + self.d_model)  # cross attn
        if self.frontend == "vlm":
            total += self.d_model * self.d_model  # patch projection
        total += self.d_model  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the top-k experts;
        enc-dec: encoder and cross-attention fully active)."""
        total = self.padded_vocab * self.d_model
        if not self.tie_embeddings:
            total += self.padded_vocab * self.d_model
        for layer in range(self.n_layers):
            total += self._layer_params(layer, active_only=True)
        if self.is_encoder_decoder:
            for _ in range(self.encoder_layers):
                total += self._attn_params() + self._dense_ffn_params() + 2 * self.d_model
            total += self.n_layers * (self._attn_params() + self.d_model)  # cross
        total += self.d_model
        return total

    def _attn_params(self) -> int:
        hd = self.head_dim
        return (
            self.d_model * self.n_heads * hd  # q
            + 2 * self.d_model * self.n_kv_heads * hd  # kv
            + self.n_heads * hd * self.d_model  # o
        )

    def _dense_ffn_params(self) -> int:
        return 3 * self.d_model * self.d_ff  # SwiGLU

    def _moe_ffn_params(self, active_only: bool = False) -> int:
        e = self.experts_per_token if active_only else self.n_experts
        return e * 3 * self.d_model * self.d_ff + self.d_model * self.n_experts

    def _mamba_params(self) -> int:
        di, n, dtr = self.d_inner, self.ssm_state, self.dt_rank_actual
        return (
            self.d_model * 2 * di  # in_proj
            + di * self.ssm_conv  # conv
            + di * (dtr + 2 * n)  # x_proj
            + dtr * di + di  # dt_proj
            + di * n + di  # A_log, D
            + di * self.d_model  # out_proj
            + (dtr + 2 * n if self.ssm_inner_norms else 0)  # dt, B, C norms
        )

    def _layer_params(self, layer: int, active_only: bool = False) -> int:
        total = 2 * self.d_model  # norms
        if self.mixer_kind(layer) == "attn":
            total += self._attn_params()
        else:
            total += self._mamba_params()
        if self.ffn_kind(layer) == "moe":
            total += self._moe_ffn_params(active_only)
        else:
            total += self._dense_ffn_params()
        return total

    # ---------------- reduced configs for smoke tests ----------------

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config that runs a CPU serve step."""
        period = self.group_size
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 * period,
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_head=16 if self.n_heads else 0,
            d_ff=128,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            max_target_len=32,
            sliding_window=32,
            frontend_tokens=8 if self.frontend_tokens else 0,
            rope_theta=10_000.0,
        )


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # importing each config module registers it, once (the import system
    # caches modules)
    from repro_torch.configs import (  # noqa: F401
        deepseek_7b,
        falcon_mamba_7b,
        gemma2_9b,
        h2o_danube_1_8b,
        internvl2_2b,
        jamba_1_5_large,
        llama3_8b,
        mixtral_8x22b,
        qwen3_moe_30b_a3b,
        whisper_medium,
    )



# ---------------------------------------------------------------------------
# Cell applicability
# ---------------------------------------------------------------------------


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell runs, and why not if
    skipped: the 500k-token decode needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
