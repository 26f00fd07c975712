"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA [arXiv:2401.16818; hf]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        attn_pattern="swa",
        sliding_window=4096,
        rope_theta=10_000.0,
        long_context_ok=True,  # SWA: windowed KV cache at 500k
    )
)
