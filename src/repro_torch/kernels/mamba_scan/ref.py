"""Plain PyTorch version of the selective scan (port of
``repro.kernels.mamba_scan.ref``): the naive sequential recurrence
h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t, y_t = (h_t . C_t).
It is the CPU path of the kernel's wrapper and the oracle the CUDA
kernel is held against on the card."""

from __future__ import annotations

import torch


def selective_scan_ref(
    dt: torch.Tensor,  # (B, S, di) f32 (post-softplus)
    a: torch.Tensor,  # (di, N) f32 (negative)
    b: torch.Tensor,  # (B, S, N) f32
    c: torch.Tensor,  # (B, S, N) f32
    x: torch.Tensor,  # (B, S, di) f32
    h0: torch.Tensor | None = None,  # (B, di, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y, hT)``: ``(B, S, di)`` outputs and the ``(B, di, N)``
    final state."""
    B, S, di = x.shape
    n = a.shape[1]
    h = (
        torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
        if h0 is None
        else h0
    )
    ys = []
    for t in range(S):
        dt_t, x_t = dt[:, t], x[:, t]  # (B, di)
        da = torch.exp(dt_t[..., None] * a[None])  # (B, di, N)
        h = h * da + (dt_t * x_t)[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h
