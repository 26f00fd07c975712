"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        n_experts=8,
        experts_per_token=2,
        moe_every=1,
        attn_pattern="swa",
        sliding_window=4096,
        rope_theta=1_000_000.0,
        long_context_ok=True,  # SWA: windowed KV cache at 500k
        notes=(
            "8 experts < model axis (16): expert weights use the TP path "
            "(d_ff sharded over 'model', experts FSDP over 'data')."
        ),
    )
)
