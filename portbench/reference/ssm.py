"""A layer of the ``ssm`` family (falcon-mamba-7b, mamba-1): RMSNorm, then
the selective state-space mixer and a residual add; float32.

The mixer: ``x, z = h W_in``; a causal depthwise conv of width K with a
bias, then SiLU; ``dt, B, C = x W_x``; ``dt = softplus(dt W_dt +
dt_bias)``; ``A = -exp(A_log)``; the recurrence ``s_t = exp(dt_t A) s_{t-1}
+ dt_t x_t B_t``, ``y_t = s_t . C_t``; ``(y + D x) silu(z) W_out``.  The
published falcon-mamba-7b also RMS-normalises B, C and dt inside the
mixer; the repository's model (and so the program) does not, and this
reference follows the repository.

The recurrence is computed without a loop over time: within chunks of
``CHUNK`` steps by a doubling (Hillis-Steele) scan of the pairs ``(a, b)``
of ``s_t = a_t s_{t-1} + b_t``, then across the chunks' ends by the same
scan, then each step's state gets its chunk's incoming state, decayed.
Every factor is a product of ``exp(dt A) <= 1``, so nothing overflows.
Channels go a block at a time; under autograd each block is recomputed
in the backward, so its intermediates are never all held.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import common as C

# leaves AdamW does not decay besides the norm scales: the SSM's dynamics
# and the conv's bias
NO_DECAY = ("dt_bias", "conv_b", "D", "A_log")

CHUNK = 16
CHANNELS = 512  # channels a block of the scan


def _doubling(a: torch.Tensor, b: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``s = a s_prev + b`` along ``dim`` from s = 0:
    returns (the running products of a, the states)."""
    n, off = a.shape[dim], 1
    while off < n:
        keep, m = b.narrow(dim, 0, off), n - off
        b = torch.cat([keep, b.narrow(dim, off, m) + a.narrow(dim, off, m) * b.narrow(dim, 0, m)],
                      dim)
        a = torch.cat([a.narrow(dim, 0, off), a.narrow(dim, off, m) * a.narrow(dim, 0, m)], dim)
        off *= 2
    return a, b


def _scan_block(dt, A, Bm, Cm, x):
    """``y`` (B, S, c) of channels ``c``: dt, x (B, S, c); A (c, N);
    Bm, Cm (B, S, N)."""
    Bsz, S, c = x.shape
    n = A.shape[1]
    pad = -S % CHUNK
    a = torch.exp(dt[..., None] * A)  # (B, S, c, N)
    b = (dt * x)[..., None] * Bm[:, :, None, :]
    if pad:
        a = torch.cat([a, a.new_ones(Bsz, pad, c, n)], 1)
        b = torch.cat([b, b.new_zeros(Bsz, pad, c, n)], 1)
    chunks = a.shape[1] // CHUNK
    a = a.view(Bsz, chunks, CHUNK, c, n)
    b = b.view(Bsz, chunks, CHUNK, c, n)
    a, b = _doubling(a, b, 2)  # states within each chunk, from 0
    _, ends = _doubling(a[:, :, -1], b[:, :, -1], 1)  # states at each chunk's end
    incoming = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    s = b + a * incoming[:, :, None]
    s = s.view(Bsz, chunks * CHUNK, c, n)[:, :S]
    return torch.einsum("bscn,bsn->bsc", s, Cm)


def scan(dt, A, Bm, Cm, x) -> torch.Tensor:
    ys = []
    for c0 in range(0, x.shape[-1], CHANNELS):
        part = (dt[..., c0:c0 + CHANNELS], A[c0:c0 + CHANNELS], Bm, Cm, x[..., c0:c0 + CHANNELS])
        if torch.is_grad_enabled():
            ys.append(checkpoint(_scan_block, *part, use_reentrant=False))
        else:
            ys.append(_scan_block(*part))
    return torch.cat(ys, -1)


def layer(cfg: dict, w: dict, i: int, x: torch.Tensor, precision: str) -> torch.Tensor:
    """Under the control every activation the program holds in its compute
    dtype (the in-projection's halves, the conv's output and its SiLU, dt,
    B and C, dt after softplus, the residual stream) is rounded too, not
    only the products' operands: the mixer's elementwise work is most of
    this family's arithmetic."""
    p = f"layers.{i}.mixer."
    n = cfg["ssm_state"]
    r = cfg.get("dt_rank") or -(-cfg["d_model"] // 16)

    def held(t):
        return C.rounded(t, precision)

    h = C.rms_norm(x, w[f"layers.{i}.norm1"], cfg["norm_eps"])
    xin, z = (held(t) for t in C.mm(h, w[p + "in_proj"], precision).chunk(2, dim=-1))
    K = w[p + "conv_w"].shape[0]
    xp = F.pad(xin, (0, 0, K - 1, 0))  # K-1 zeros before the first step
    conv = w[p + "conv_b"].float() + sum(
        w[p + "conv_w"][j].float() * xp[:, j:j + xin.shape[1]] for j in range(K))
    xc = held(C.silu(held(conv)))
    dt, Bm, Cm = (held(t) for t in C.mm(xc, w[p + "x_proj"], precision).split([r, n, n], dim=-1))
    dt = held(F.softplus(C.mm(dt, w[p + "dt_proj"], precision) + w[p + "dt_bias"].float()))
    A = -torch.exp(w[p + "A_log"].float())
    y = scan(dt, A, Bm, Cm, xc)
    y = (y + xc * w[p + "D"].float()) * C.silu(z)
    return held(x + C.mm(y, w[p + "out_proj"], precision))
