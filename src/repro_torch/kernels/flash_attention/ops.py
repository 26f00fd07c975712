"""Public wrapper for the flash-attention kernel (port of
``repro.kernels.flash_attention.ops``) in the model's (B, S, H, dh)
layout.  The kernel reads and writes that layout through strides, so
there are no transposes; the output is allocated in the model layout."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention


def mha_flash(
    q: torch.Tensor,  # (B, Sq, H, dh) — model layout
    k: torch.Tensor,  # (B, Skv, Kv, dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """``(B, Sq, H, dh)`` attention output in q's dtype, on q's device."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, logit_cap=logit_cap, out=out.transpose(1, 2),
    )
    return out
