"""whisper-medium [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-medium",
        family="audio",
        n_layers=24,  # decoder layers
        encoder_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,  # MHA
        d_ff=4096,
        vocab_size=51865,
        attn_pattern="full",
        max_target_len=448,
        frontend="audio_frames",
        tie_embeddings=True,
        long_context_ok=False,
        notes=(
            "Backbone only: input_specs() provides precomputed frame "
            "embeddings (B, seq, d_model) in place of the conv frontend. "
            "Shape cells size the ENCODER sequence; the decoder is capped "
            "at 448 tokens (model limit). decode_* attends a cross-KV "
            "cache of seq_len encoder states."
        ),
    )
)
