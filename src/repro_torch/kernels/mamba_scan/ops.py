"""Public wrapper for the selective-scan kernel (port of
``repro.kernels.mamba_scan.ops``): casts every input to float32 (and
makes it contiguous) and runs the scan on the inputs' device."""

from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan.kernel import selective_scan


def ssm_scan(
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """``y`` (B, S, di) float32 of the mamba-1 forward scan; inputs of any
    float dtype."""
    def f32(t):
        return t.to(torch.float32).contiguous()

    return selective_scan(f32(dt), f32(a), f32(b), f32(c), f32(x))
