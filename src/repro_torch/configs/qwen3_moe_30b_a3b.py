"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,  # qwen3 uses explicit head_dim 128
        d_ff=768,  # per-expert FFN width
        vocab_size=151936,
        n_experts=128,
        experts_per_token=8,
        moe_every=1,
        attn_pattern="full",
        rope_theta=1_000_000.0,
        long_context_ok=False,  # pure full attention
        notes=(
            "128 experts >= model axis: EP path (experts sharded over "
            "'model', all-to-all dispatch — the paper's per-thread class)."
        ),
    )
)
