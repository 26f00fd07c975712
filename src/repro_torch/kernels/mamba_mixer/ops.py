"""Public wrappers for the mamba mixer's prefill passes: take the model's
leaves as they are served (``conv_w`` and ``conv_b`` in the compute
dtype, ``dt_bias`` and ``D`` in any float dtype) and hand the kernels'
wrappers (:mod:`~repro_torch.kernels.mamba_mixer.kernel`) contiguous
leaves, ``dt_bias`` and ``D`` widened to float32 (exactly).  Without
autograd only: nothing here has a backward."""

from __future__ import annotations

import torch

from repro_torch.kernels.mamba_mixer import kernel


def conv_silu(xin: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor):
    """``(x_conv, xf)`` of the causal conv and SiLU from zero history."""
    return kernel.conv_silu(xin, conv_w.contiguous(), conv_b.contiguous())


def dt_softplus(dt_raw: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """float32 ``dt`` from ``dt @ dt_proj`` and the bias."""
    return kernel.dt_softplus(dt_raw.contiguous(), dt_bias.to(torch.float32).contiguous())


def mixer_gate(y: torch.Tensor, x_conv: torch.Tensor, D: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """The D skip and the silu(z) gate, rounded to the compute dtype."""
    return kernel.mixer_gate(y, x_conv, D.to(torch.float32).contiguous(), z)
