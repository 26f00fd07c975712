"""Plain PyTorch version of the selective scan (port of
``repro.kernels.mamba_scan.ref``): the naive sequential recurrence
h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t, y_t = (h_t . C_t).
It is the CPU path of the kernel's wrapper and the oracle the CUDA
kernel is held against on the card; :func:`selective_scan_bwd_ref` is the
same for the backward kernel."""

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


def selective_scan_bwd_ref(
    dt: torch.Tensor,  # (B, S, di) f32
    a: torch.Tensor,  # (di, N) f32
    b: torch.Tensor,  # (B, S, N) f32
    c: torch.Tensor,  # (B, S, N) f32
    x: torch.Tensor,  # (B, S, di) f32
    dy: torch.Tensor,  # (B, S, di) f32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ddt, da, db, dc, dx)`` of :func:`selective_scan_ref` from a zero
    state, for the output gradient ``dy``: the reverse recurrence
    lambda_t = C_t dy_t + exp(dt_{t+1} A) lambda_{t+1} (the backward of the
    reference's ``_linear_scan`` with the C contraction folded in), then
    ddt_t = sum_n lambda_t (A exp(dt_t A) h_{t-1} + x_t B_t),
    dx_t = sum_n lambda_t dt_t B_t, dA = sum_{b,t} lambda_t exp(dt_t A)
    h_{t-1} dt_t, dB_t = sum_d lambda_t dt_t x_t, dC_t = sum_d dy_t h_t."""
    B, S, di = x.shape
    n = a.shape[1]
    zero = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    hs, h = [], zero
    for t in range(S):
        h = h * torch.exp(dt[:, t, :, None] * a) + (dt[:, t] * x[:, t])[..., None] * b[:, t, None]
        hs.append(h)
    ddt, dx = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da_sum = torch.zeros_like(a)
    lam, da_next = zero, zero
    for t in reversed(range(S)):
        da = torch.exp(dt[:, t, :, None] * a)
        lam = lam * da_next + c[:, t, None, :] * dy[:, t, :, None]
        g = lam * (hs[t - 1] if t else zero) * da
        lam_b = (lam * b[:, t, None, :]).sum(-1)
        ddt[:, t] = (g * a).sum(-1) + lam_b * x[:, t]
        dx[:, t] = lam_b * dt[:, t]
        da_sum += (g * dt[:, t, :, None]).sum(0)
        db[:, t] = (lam * (dt[:, t] * x[:, t])[..., None]).sum(1)
        dc[:, t] = (dy[:, t, :, None] * hs[t]).sum(1)
        da_next = da
    return ddt, da_sum, db, dc, dx
