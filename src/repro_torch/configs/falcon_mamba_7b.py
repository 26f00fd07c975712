"""falcon-mamba-7b [ssm] — mamba1 arch, attention-free [arXiv:2410.05355]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,  # attention-free, no separate FFN: mamba block IS the layer
        vocab_size=65024,
        attn_pattern="none",
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,  # d_inner = 8192
        long_context_ok=True,  # O(1)-state decode
        notes=(
            "Attention-free: the paper's attention-sharding aspects do not "
            "apply; TP shards d_inner channels (independent across the scan)."
        ),
    )
)
