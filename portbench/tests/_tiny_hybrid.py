"""A tiny configuration of the ``hybrid`` family, for the CPU: one
period of AI21-Jamba2-Mini's pattern (attention at slot 4, experts at
the odd slots), its keys as the configuration file names them, at tiny
widths."""

from __future__ import annotations

from portbench.tests._tiny import DTYPES

HYBRID = dict(name="tiny-hybrid", family="hybrid", n_layers=8, d_model=64, n_heads=4,
              n_kv_heads=2, d_head=16, d_ff=128, vocab_size=512, attn_pattern="full",
              attn_every=8, attn_offset=4, rotary=False, ssm_state=8, ssm_conv=4, ssm_expand=2,
              dt_rank=8, ssm_inner_norms=True, n_experts=8, experts_per_token=2, moe_every=2,
              moe_renormalize=False, moe_dropless=True,
              attn_layer_offset=4, attn_layer_period=8, expert_layer_offset=1,
              expert_layer_period=2, hidden_size=64, intermediate_size=128, mamba_d_conv=4,
              mamba_d_state=8, mamba_dt_rank=8, mamba_expand=2, num_attention_heads=4,
              num_experts=8, num_experts_per_tok=2, num_hidden_layers=8, num_key_value_heads=2,
              rms_norm_eps=1e-6, **dict(DTYPES, norm_eps=1e-6))
