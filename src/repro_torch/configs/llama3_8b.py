"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama3-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        attn_pattern="full",
        rope_theta=500_000.0,
        long_context_ok=False,
    )
)
