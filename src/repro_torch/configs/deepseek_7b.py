"""deepseek-7b [dense] — llama-arch, MHA (kv=32) [arXiv:2401.02954; hf]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-7b",
        family="dense",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab_size=102400,
        attn_pattern="full",
        rope_theta=10_000.0,
        long_context_ok=False,
    )
)
