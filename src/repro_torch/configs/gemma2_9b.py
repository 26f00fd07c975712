"""gemma2-9b [dense] — local+global alternating, logit softcap [arXiv:2408.00118]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        d_head=256,  # gemma2 uses wide heads (q proj 3584 -> 4096)
        d_ff=14336,
        vocab_size=256000,
        attn_pattern="local_global",
        sliding_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        rope_theta=10_000.0,
        tie_embeddings=True,
        long_context_ok=False,  # global layers are quadratic; see DESIGN.md
        notes="long_500k skipped: alternating pattern still has full-attention layers.",
    )
)
