"""Public wrapper for the selective-scan kernels (port of
``repro.kernels.mamba_scan.ops``): casts every input to float32 (and
makes it contiguous) and runs the scan on the inputs' device.

Without autograd (serving) :func:`ssm_scan` launches the forward alone.
When an input requires a gradient it runs as a ``torch.autograd.Function``
whose forward also saves the chunk states and whose backward is the
backward kernel (:func:`~repro_torch.kernels.mamba_scan.kernel.
selective_scan_bwd`) on a card, the plain backward on the CPU; the casts
around it carry the gradients back to the inputs' dtypes.  The backward
counts into the recording its forward ran under
(``parallel.context.record``), whichever thread autograd runs it on."""

from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan.kernel import selective_scan, selective_scan_bwd
from repro_torch.parallel import context


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, a, b, c, x):
        y, states = selective_scan(dt, a, b, c, x, save_states=True)
        ctx.save_for_backward(dt, a, b, c, x, states)
        ctx.recording = context.current_recording()  # the backward's, on any thread
        return y

    @staticmethod
    def backward(ctx, dy):
        dt, a, b, c, x, states = ctx.saved_tensors
        with context.recording_as(ctx.recording):
            ddt, da, db, dc, dx = selective_scan_bwd(dt, a, b, c, x, dy.contiguous(), states)
        return ddt, da, db, dc, dx


def ssm_scan(
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """``y`` (B, S, di) float32 of the mamba-1 forward scan; inputs of any
    float dtype; differentiable in every input."""
    def f32(t):
        return t.to(torch.float32).contiguous()

    args = tuple(f32(t) for t in (dt, a, b, c, x))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SelectiveScan.apply(*args)
    return selective_scan(*args)
