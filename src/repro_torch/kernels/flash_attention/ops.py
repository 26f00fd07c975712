"""Public wrapper for the flash-attention kernels (port of
``repro.kernels.flash_attention.ops``) in the model's (B, S, H, dh)
layout.  The kernels read and write that layout through strides, so
there are no transposes; outputs are allocated in the model layout.

Without autograd (serving) :func:`mha_flash` launches the forward alone.
When an input requires a gradient it runs as a ``torch.autograd.Function``:
the forward also keeps the float32 log-sum-exp, and the backward is the
backward kernel (:func:`~repro_torch.kernels.flash_attention.kernel.
flash_attention_bwd`) on a card, the plain backward on the CPU; the
gradients come back in the inputs' dtypes.  The backward counts into the
recording its forward ran under (``parallel.context.record``), whichever
thread autograd runs it on."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    _tma_aligned,
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.parallel import context


def _t(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) <-> (B, H, S, dh) as a view."""
    return x.transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        # the kernel's backward needs the log-sum-exp; the plain one recomputes it
        lse = None if q.device.type == "cpu" else torch.empty(
            (q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32, device=q.device)
        flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                        logit_cap=logit_cap, out=_t(out), lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = dict(causal=causal, window=window, logit_cap=logit_cap)
        ctx.recording = context.current_recording()  # the backward's, on any thread
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # the kernels read dh contiguously, the bf16 one through TMA: a
        # gradient that does not fit is copied (contiguous() would keep a
        # contiguous view whose base is off by a few bytes)
        if dout.stride(-1) != 1 or (dout.dtype == torch.bfloat16 and not _tma_aligned(_t(dout))):
            dout = dout.clone(memory_format=torch.contiguous_format)
        grads = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
        with context.recording_as(ctx.recording):
            flash_attention_bwd(_t(q), _t(k), _t(v), _t(out), _t(dout), lse,
                                grads=tuple(_t(g) for g in grads), **ctx.options)
        return (*grads, None, None, None)


def mha_flash(
    q: torch.Tensor,  # (B, Sq, H, dh) — model layout
    k: torch.Tensor,  # (B, Skv, Kv, dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """``(B, Sq, H, dh)`` attention output in q's dtype, on q's device;
    differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, logit_cap)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention(
        _t(q), _t(k), _t(v), causal=causal, window=window, logit_cap=logit_cap, out=_t(out),
    )
    return out
