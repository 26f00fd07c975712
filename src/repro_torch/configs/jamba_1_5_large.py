"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7, MoE 16e top-2 [arXiv:2403.19887]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        n_experts=16,
        experts_per_token=2,
        moe_every=2,  # MoE replaces the dense FFN every 2nd layer
        attn_pattern="full",
        attn_every=8,  # 1 attention : 7 mamba per Jamba block
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,  # d_inner = 16384
        rope_theta=10_000.0,
        moment_dtype="bfloat16",  # 398B: fp32 moments would not fit 256 chips
        long_context_ok=True,  # hybrid: 9 attention layers, rest O(1)-state
        notes=(
            "16 experts = model axis: EP path. bf16 Adam moments keep "
            "optimizer state at ~9.4 GB/chip on the single-pod mesh."
        ),
    )
)
