"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab_size=92553,
        attn_pattern="full",
        rope_theta=1_000_000.0,
        frontend="vit_patches",
        frontend_tokens=256,  # one image tile's worth of patch embeddings
        long_context_ok=False,
        notes=(
            "LM backbone only: input_specs() provides precomputed ViT patch "
            "embeddings (B, 256, d_model) prepended to the token sequence."
        ),
    )
)
