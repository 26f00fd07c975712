"""Pieces the reference models share: float32 products (or, for the
control, products of operands rounded to float8 e4m3 with one scale per
tensor), RMSNorm with the ``(1 + w)`` scale, rotary embeddings, causal
windowed attention computed a block of query rows at a time (forward and
backward, so no (S, S) matrix is ever held), the training loss and the
layer loop.

``precision`` is ``"float32"`` (the reference) or ``"fp8"`` (the
control: what a program computing its products in float8 would give).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0
ATTN_ROWS = 1024  # query rows a block of the attention


def full_float32() -> None:
    """Products in full float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude at the format's largest value), back in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()  # straight through for the gradient


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    x = x.float()
    return fp8(x) if precision == "fp8" else x


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` in float32, the operands rounded for the control."""
    return rounded(x, precision) @ rounded(w, precision)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` (B, S, heads, dh) at positions 0..S-1:
    the first and second halves of each head rotated as pairs, with
    frequencies ``theta ** (-i / (dh / 2))``."""
    S, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _keys(r0: int, r1: int, window: int) -> int:
    """The first key any of rows r0..r1-1 sees (causal, ``window``)."""
    return max(0, r0 - window + 1) if window else 0


def _scores(q, k, r0, k0, window, scale):
    """Masked scores of query rows r0.. (q: (B, Kv, G, R, dh)) against keys
    k0.. (k: (B, Kv, K, dh)): (B, Kv, G, R, K) float32."""
    s = torch.einsum("bkgrd,bksd->bkgrs", q, k) * scale
    rows = torch.arange(r0, r0 + q.shape[3], device=q.device)[:, None]
    cols = torch.arange(k0, k0 + k.shape[2], device=q.device)[None, :]
    ok = cols <= rows
    if window:
        ok &= cols > rows - window
    return s.masked_fill(~ok, -math.inf)


class _Attention(torch.autograd.Function):
    """Causal attention with an optional window, GQA by groups of query
    heads; q (B, Kv, G, S, dh), k and v (B, Kv, S, dh), float32."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        S, dh = q.shape[3], q.shape[4]
        scale = dh**-0.5
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:4], dtype=torch.float32, device=q.device)
        for r0 in range(0, S, ATTN_ROWS):
            r1 = min(r0 + ATTN_ROWS, S)
            k0 = _keys(r0, r1, window)
            s = _scores(q[:, :, :, r0:r1], k[:, :, k0:r1], r0, k0, window, scale)
            m = torch.logsumexp(s, dim=-1, keepdim=True)
            lse[:, :, :, r0:r1] = m[..., 0]
            out[:, :, :, r0:r1] = torch.einsum("bkgrs,bksd->bkgrd", torch.exp(s - m),
                                               v[:, :, k0:r1])
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        window, S, dh = ctx.window, q.shape[3], q.shape[4]
        scale = dh**-0.5
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        for r0 in range(0, S, ATTN_ROWS):
            r1 = min(r0 + ATTN_ROWS, S)
            k0 = _keys(r0, r1, window)
            qa, doa = q[:, :, :, r0:r1], dout[:, :, :, r0:r1]
            p = torch.exp(_scores(qa, k[:, :, k0:r1], r0, k0, window, scale)
                          - lse[:, :, :, r0:r1, None])
            dv[:, :, k0:r1] += torch.einsum("bkgrs,bkgrd->bksd", p, doa)
            dp = torch.einsum("bkgrd,bksd->bkgrs", doa, v[:, :, k0:r1])
            ds = p * (dp - (doa * out[:, :, :, r0:r1]).sum(-1, keepdim=True)) * scale
            dq[:, :, :, r0:r1] = torch.einsum("bkgrs,bksd->bkgrd", ds, k[:, :, k0:r1])
            dk[:, :, k0:r1] += torch.einsum("bkgrs,bkgrd->bksd", ds, qa)
        return dq, dk, dv, None


def attention(q, k, v, window: int, precision: str) -> torch.Tensor:
    """q (B, S, H, dh), k and v (B, S, Kv, dh) -> (B, S, H, dh) float32."""
    B, S, H, dh = q.shape
    kv = k.shape[2]
    q = rounded(q, precision).view(B, S, kv, H // kv, dh).permute(0, 2, 3, 1, 4)
    k = rounded(k, precision).permute(0, 2, 1, 3)
    v = rounded(v, precision).permute(0, 2, 1, 3)
    out = _Attention.apply(q.contiguous(), k.contiguous(), v.contiguous(), window)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh)


def silu(x):
    return F.silu(x)


def hidden(model, cfg: dict, w: dict, tokens: torch.Tensor, precision: str,
           remat: bool = False) -> torch.Tensor:
    """Embedding, every layer of ``model`` (a family module's ``layer``),
    the final norm: (B, S, d) float32.  ``remat`` recomputes each layer in
    the backward (memory, not arithmetic)."""
    x = w["embed.table"][tokens].float()
    for i in range(cfg["n_layers"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(model.layer, cfg, w, i, x, precision, use_reentrant=False)
        else:
            x = model.layer(cfg, w, i, x, precision)
    return rms_norm(x, w["final_norm"], cfg["norm_eps"])


def logits(cfg: dict, w: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    """Logits over the real vocabulary (the padded rows are no tokens)."""
    return mm(h, w["lm_head"][:, : cfg["vocab_size"]], precision)


def loss(cfg: dict, w: dict, h: torch.Tensor, labels: torch.Tensor, precision: str,
         z_loss: float) -> torch.Tensor:
    """Mean next-token NLL over the real vocabulary plus ``z_loss`` times
    the mean squared log-sum-exp."""
    lg = logits(cfg, w, h, precision)
    lse = torch.logsumexp(lg, dim=-1)
    nll = lse - torch.gather(lg, -1, labels[..., None].long())[..., 0]
    return nll.mean() + z_loss * (lse * lse).mean()
