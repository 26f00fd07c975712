"""Plain PyTorch version of flash attention (port of
``repro.kernels.flash_attention.ref``): naive direct attention with
materialised float32 logits, GQA by repeating K/V heads, right-aligned
causal masking, an optional sliding window and tanh soft-cap, mask value
-1e30.  It is the CPU path of the kernel's wrapper and the oracle the
CUDA kernel is held against on the card."""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, dh)
    k: torch.Tensor,  # (B, Kv, Skv, dh)
    v: torch.Tensor,  # (B, Kv, Skv, dh)
    *,
    causal: bool = True,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """``(B, H, Sq, dh)`` attention output in q's dtype."""
    B, H, Sq, dh = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    G = H // Kv
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    logits = torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) * (dh**-0.5)
    if logit_cap > 0.0:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    rows = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)  # right-aligned
    cols = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= cols <= rows
    if window:
        ok &= cols > rows - window
    logits = torch.where(ok, logits, -1e30)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqs,bhsd->bhqd", w, v.float())
    return out.to(q.dtype)
