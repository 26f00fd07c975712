"""Shared layers (port of ``repro.models.layers``): norms, rotary
embeddings, sinusoidal positions, the SwiGLU FFN, embeddings.

Under a mesh the SwiGLU weights are split by ``d_ff`` and the embedding
table and ``lm_head`` by vocabulary over ``tp`` (``model``; ``model`` x
``data`` under 2-D decode tensor parallelism): the FFN's and the lookup's
partial results are added over those ranks and the logits gathered (see
:mod:`repro_torch.parallel.context`).  The replicated activations
entering the split products pass through ``context.fan_out``, so their
gradients add the ranks' parts."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.parallel import context as ctx


def weight(t: torch.Tensor) -> nn.Parameter:
    """A model leaf: an inference-only parameter until
    ``model.train_mode`` makes it trainable."""
    return nn.Parameter(t, requires_grad=False)


class Embed(nn.Module):
    """The token table, ``(padded_vocab, d_model)``."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = weight(table)


class SwiGLU(nn.Module):
    """A dense FFN's three matrices, ``x @ w`` orientation."""

    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor):
        super().__init__()
        self.w_gate = weight(w_gate)
        self.w_up = weight(w_up)
        self.w_down = weight(w_down)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the ``(1 + w)`` scale, computed in float32, returned
    in x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + w.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2-style logit soft capping."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding with float32 angles, in x's dtype.

    ``x``: (..., seq, heads, head_dim); ``positions``: (..., seq) int.
    """
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freq  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
) -> torch.Tensor:
    """SwiGLU FFN: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``, summed
    over ``model`` where the weights are this rank's ``d_ff`` columns."""
    x = ctx.fan_out(x, ctx.physical_axes("tp"))
    h = torch.nn.functional.silu(x @ w_gate) * (x @ w_up)
    return ctx.matmul_psum(h, w_down, ctx.physical_axes("tp"))


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for integer ``tokens`` of any shape.  Its
    gradient on a card sums repeated tokens' rows in a fixed order
    (``F.embedding``'s sorted backward; ``index_select``'s adds them with
    atomics), so a training step repeats bit for bit.  Under a mesh
    ``table`` is this rank's block of the vocabulary: tokens outside it get
    zeros, and the rows are added over ``model`` (one nonzero term each,
    so exactly)."""
    tp = ctx.physical_axes("tp")
    if ctx.axis_size("tp") == 1:
        return torch.nn.functional.embedding(tokens, table)
    rows = table.shape[0]
    ids = tokens - ctx.axis_index(tp) * rows
    mine = (ids >= 0) & (ids < rows)
    out = torch.nn.functional.embedding(ids.clamp(0, rows - 1), table)
    return ctx.psum(out.masked_fill(~mine[..., None], 0), tp)


def unembed(
    x: torch.Tensor, table: torch.Tensor, *, transpose: bool, cap: float = 0.0
) -> torch.Tensor:
    """Project to (padded) vocab logits, soft-capped when ``cap > 0``.
    Under a mesh ``table`` holds this rank's block of the vocabulary; each
    block's logits are capped, then gathered over ``model`` in vocabulary
    order (so an argmax keeps the first maximal index of the whole); every
    rank then computes the same thing on them."""
    tp = ctx.physical_axes("tp")
    logits = ctx.fan_out(x, tp) @ (table.T if transpose else table)
    if cap > 0.0:
        logits = softcap(logits, cap)
    return ctx.all_gather(logits, tp, -1, adjoint="slice")


def sinusoidal_positions(length: int, dim: int, *, device=None) -> torch.Tensor:
    """Fixed sinusoidal embeddings (whisper's encoder), ``(length, dim)``
    float32: the sines of ``pos / 10000**(2 i / dim)`` for ``i <
    dim // 2``, then their cosines (concatenated, not interleaved)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angles = pos / torch.pow(10_000.0, 2 * idx / dim)
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
