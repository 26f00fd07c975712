"""Plain PyTorch version of flash attention (port of
``repro.kernels.flash_attention.ref``): naive direct attention with
materialised float32 logits, GQA by repeating K/V heads, right-aligned
causal masking, an optional sliding window and tanh soft-cap, mask value
-1e30.  It is the CPU path of the kernel's wrapper and the oracle the
CUDA kernel is held against on the card; :func:`attention_bwd_ref` is the
same for the backward kernel."""

from __future__ import annotations

import torch


def _visible(sq: int, skv: int, causal: bool, window: int, device, rows=None) -> torch.Tensor:
    """``(len(rows), Skv)`` bool: which keys each query row may see (rows
    right-aligned: row ``r`` sits at position ``r + Skv - Sq``)."""
    if rows is None:
        rows = torch.arange(sq, device=device)
    pos = rows[:, None] + (skv - sq)
    cols = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((rows.numel(), skv), dtype=torch.bool, device=device)
    if causal:
        ok &= cols <= pos
    if window:
        ok &= cols > pos - window
    return ok


def masked_scores(
    q: torch.Tensor,  # (B, H, Sq, dh)
    k: torch.Tensor,  # (B, Kv, Skv, dh)
    *,
    causal: bool = True,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """``(B, H, Sq, Skv)`` float32 scores: ``q k^T dh^-1/2``, soft-capped,
    masked to -1e30."""
    H, Sq, dh = q.shape[1], q.shape[2], q.shape[3]
    k = k.repeat_interleave(H // k.shape[1], dim=1)
    logits = torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) * (dh**-0.5)
    if logit_cap > 0.0:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    ok = _visible(Sq, k.shape[2], causal, window, q.device)
    return torch.where(ok, logits, -1e30)


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
    G = q.shape[1] // k.shape[1]
    v = v.repeat_interleave(G, dim=1)
    logits = masked_scores(q, k, causal=causal, window=window, logit_cap=logit_cap)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqs,bhsd->bhqd", w, v.float())
    return out.to(q.dtype)


def attention_lse_ref(q, k, *, causal=True, window=0, logit_cap=0.0) -> torch.Tensor:
    """``(B, H, Sq)`` float32 row log-sum-exp of :func:`masked_scores`."""
    return torch.logsumexp(
        masked_scores(q, k, causal=causal, window=window, logit_cap=logit_cap), dim=-1
    )


def attention_bwd_ref(
    q: torch.Tensor,  # (B, H, Sq, dh)
    k: torch.Tensor,  # (B, Kv, Skv, dh)
    v: torch.Tensor,  # (B, Kv, Skv, dh)
    dout: torch.Tensor,  # (B, H, Sq, dh)
    *,
    causal: bool = True,
    window: int = 0,
    logit_cap: float = 0.0,
    rows: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`attention_ref` for the output gradient
    ``dout``, in the inputs' dtypes, by the explicit formulas in float32:
    P = softmax(S), dV = P^T dO, dS = P (dO V^T - rowsum(dO O)) cap'(S),
    dQ = dS K dh^-1/2, dK = dS^T Q dh^-1/2, with GQA's q-heads summed into
    their kv-head.  Masked entries carry P = 0, so a row that sees no key
    gets zero gradients.  ``rows`` computes ``rows`` query rows at a time,
    so a long sequence never holds its whole (Sq, Skv) score matrix."""
    B, H, Sq, dh = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = dh**-0.5
    k32 = k.float().repeat_interleave(G, dim=1)
    v32 = v.float().repeat_interleave(G, dim=1)
    dq = torch.empty((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, H, Skv, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, H, Skv, dh), dtype=torch.float32, device=q.device)
    step = rows or Sq
    for a in range(0, Sq, step):
        b = min(a + step, Sq)
        qa, doa = q[:, :, a:b].float(), dout[:, :, a:b].float()
        s = qa @ k32.transpose(-1, -2) * scale
        if logit_cap > 0.0:
            t = torch.tanh(s / logit_cap)
            s = logit_cap * t
        ok = _visible(Sq, Skv, causal, window, q.device, torch.arange(a, b, device=q.device))
        s = torch.where(ok, s, -1e30)
        p = torch.where(ok, torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True)), 0.0)
        del s
        o = p @ v32
        dv += p.transpose(-1, -2) @ doa
        ds = p * (doa @ v32.transpose(-1, -2) - (doa * o).sum(dim=-1, keepdim=True))
        del p, o
        if logit_cap > 0.0:
            ds = ds * (1.0 - t * t)
            del t
        dq[:, :, a:b] = ds @ k32 * scale
        dk += ds.transpose(-1, -2) @ qa * scale
    dk = dk.view(B, Kv, G, Skv, dh).sum(dim=2)
    dv = dv.view(B, Kv, G, Skv, dh).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
