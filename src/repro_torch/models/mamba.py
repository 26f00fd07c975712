"""Mamba-1 mixer (port of ``repro.models.mamba``): the selective state
space block, its O(1) decode step and its conv / SSM cache.

* Prefill (:func:`mamba_mixer`): in-projection, causal depthwise conv,
  the x-projection (with ``cfg.ssm_inner_norms`` its dt, B and C
  RMS-normalised, as the published jamba's are), softplus dt, then the
  scan through ``ssm_scan``, which on a card launches K2 (the
  hand-written selective-scan kernel) and on the CPU runs its plain
  version; then the skip ``D``, the ``silu(z)`` gate and
  the out-projection.  On a card the conv with its SiLU, the dt
  softplus and the skip with the gate are three hand-written passes
  (``kernels/mamba_mixer``); when autograd records the call (training's
  forward and its recompute) each is an autograd Function whose backward
  is a hand-written pass too.  On the CPU and on ``meta`` they are the
  plain chain of ``kernels/mamba_mixer/ref.py``, which autograd
  differentiates in training.  The reference's prefill scans in chunks of an
  associative scan with bf16 level tensors (its TPU route to a scan); the
  port's scan is K2, float32 throughout, so the two differ by the
  reference's bf16 rounding (about 6e-4 of the output's scale at the
  reduced falcon-mamba-7b).
* Decode (:func:`mamba_decode`): one step of the recurrence against the
  cache, elementwise tensor code (the reference's step is float32 too).
  The cache is updated in place (the reference returns a new one).
* Under a mesh each rank holds a block of the ``d_inner`` channels (its
  channels of ``in_proj``'s x and z halves, of the conv, ``dt_proj``,
  ``A_log``, ``D`` and the caches; its rows of ``x_proj`` and
  ``out_proj``), so K2 runs on the local channels; the ``x_proj`` and
  ``out_proj`` partial sums are added over ``model``.  Under 2-D decode
  tensor parallelism the channels lie over ``model`` x ``data`` and the
  sums run over both; the decode cache holds the rank's channels of every
  row the step computes (``launch.mesh.shard_cache``).  The mixer's input
  and the summed ``x_proj`` output (dt, B and C, which each rank uses on
  its own channels) pass through ``context.fan_out``, so their gradients
  add the ranks' parts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_mixer import ops as mixer_ops
from repro_torch.kernels.mamba_mixer.ref import (
    causal_conv,
    conv_silu_ref,
    dt_softplus_ref,
    mixer_gate_ref,
)
from repro_torch.kernels.mamba_scan.ops import ssm_scan
from repro_torch.models.layers import rms_norm, weight
from repro_torch.parallel import context as ctx
from repro_torch.runtime.trace import span


class Mamba(nn.Module):
    """One mamba layer's leaves, named as the reference's tree, ``x @ w``
    orientation: ``in_proj`` (D, 2 di), ``conv_w`` (K, di), ``conv_b``
    (di,), ``x_proj`` (di, dt_rank + 2N), ``dt_proj`` (dt_rank, di),
    ``dt_bias`` (di,), ``A_log`` (di, N), ``D`` (di,), ``out_proj``
    (di, D); with ``cfg.ssm_inner_norms`` also the scales of the RMSNorms
    of dt, B and C (``NORMS``: (dt_rank,), (N,), (N,), float32), ``None``
    without."""

    LEAVES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D",
              "out_proj")
    NORMS = ("dt_norm", "b_norm", "c_norm")

    def __init__(self, in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log, D, out_proj,
                 dt_norm=None, b_norm=None, c_norm=None):
        super().__init__()
        for name, t in zip(self.LEAVES, (in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias,
                                         A_log, D, out_proj)):
            setattr(self, name, weight(t))
        for name, t in zip(self.NORMS, (dt_norm, b_norm, c_norm)):
            self.register_parameter(name, None if t is None else weight(t))


def init_mamba_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype,
    device,
    *,
    master: torch.dtype = torch.float32,
) -> Mamba:
    """Random leaves with the reference's scales, drawn in float32 from
    ``generator`` (on ``device``): the matmul weights and ``conv_b`` in
    ``dtype``, ``dt_bias`` in ``master`` (the parameter dtype: the compute
    cast keeps it), ``A_log = log(1..N)`` and ``D = 1`` in float32, and
    with ``cfg.ssm_inner_norms`` the norms' scales at 0 (``1 + w``)."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, kconv = cfg.dt_rank_actual, cfg.ssm_conv

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return t.mul_(scale).to(dtype)

    a = torch.arange(1, n + 1, dtype=torch.float32, device=device).expand(di, n)
    return Mamba(
        normal((d, 2 * di), d**-0.5),
        normal((kconv, di), kconv**-0.5),
        torch.zeros(di, dtype=dtype, device=device),
        normal((di, dtr + 2 * n), di**-0.5),
        normal((dtr, di), dtr**-0.5),
        torch.full((di,), -4.6, dtype=master, device=device),  # softplus^-1(0.01)
        torch.log(a),
        torch.ones(di, dtype=torch.float32, device=device),
        normal((di, d), di**-0.5),
        *([torch.zeros(w, dtype=torch.float32, device=device) for w in (dtr, n, n)]
          if cfg.ssm_inner_norms else ()),
    )


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, K-1, d_inner): the trailing conv window, in the cache dtype
    ssm: torch.Tensor  # (B, d_inner, N): the recurrent state, float32


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, device) -> MambaCache:
    """A zeroed cache: the conv window in ``dtype``, the state in float32."""
    return MambaCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        ssm=torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
    )


def _projections(cfg: ModelConfig, p: Mamba, x_conv: torch.Tensor):
    """The pre-scan products: ``(dt_raw, b, c)``, ``dt_raw = dt @
    dt_proj`` (B, S, di) in the compute dtype and b, c (B, S, N)
    float32.  With ``cfg.ssm_inner_norms`` dt, B and C are each
    RMS-normalised over its own width first (the published jamba's
    ``dt_layernorm``, ``b_layernorm``, ``c_layernorm``): dt back in the
    compute dtype for its product, B and C kept in float32."""
    dtr, n = cfg.dt_rank_actual, cfg.ssm_state
    tp = ctx.physical_axes("tp")
    x_dbl = ctx.fan_out(ctx.matmul_psum(x_conv, p.x_proj, tp), tp)  # (B, S, dtr + 2N)
    dt, b, c = x_dbl.split([dtr, n, n], dim=-1)
    if cfg.ssm_inner_norms:
        dt = rms_norm(dt, p.dt_norm, cfg.norm_eps)
        b = rms_norm(b.float(), p.b_norm, cfg.norm_eps)
        c = rms_norm(c.float(), p.c_norm, cfg.norm_eps)
    return dt @ p.dt_proj, b.float(), c.float()


def _ssm_inputs(cfg: ModelConfig, p: Mamba, x_conv: torch.Tensor):
    """The pre-scan projections, in the reference's rounding order:
    ``dt_bias`` cast to the compute dtype before the add, softplus in the
    compute dtype, float32 after.  Returns ``(dt, a, b, c)``: dt (B, S,
    di), a = -exp(A_log) (di, N), b and c (B, S, N), all float32."""
    dt_raw, b, c = _projections(cfg, p, x_conv)
    return dt_softplus_ref(dt_raw, p.dt_bias), -torch.exp(p.A_log), b, c


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def mamba_mixer(cfg: ModelConfig, p: Mamba, x: torch.Tensor) -> torch.Tensor:
    """The full-sequence (prefill) mixer: ``x`` (B, S, D) -> (B, S, D) in
    x's dtype.  Its scan is K2 on a card (one launch) and the plain
    version on the CPU; there is no fallback between them.  On a card the
    chain around K2 is three hand-written passes (:func:`_card_passes`),
    served or trained; on the CPU it is plain tensor code."""
    x = ctx.fan_out(x, ctx.physical_axes("tp"))
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)  # (B, S, di) each, views
    if _on_card(x):
        return _card_passes(cfg, p, xin, z)
    with span("mamba.conv"):
        x_conv, xf = conv_silu_ref(xin, p.conv_w, p.conv_b)
    dt, a, b, c = _ssm_inputs(cfg, p, x_conv)
    y = ssm_scan(dt, a, b, c, xf)  # (B, S, di) float32
    return _out_proj(mixer_gate_ref(y, xf, p.D, z), p)


def _card_passes(cfg: ModelConfig, p: Mamba, xin: torch.Tensor, z: torch.Tensor):
    """The mixer after ``in_proj`` on a card: the conv and SiLU, the dt
    softplus and the D skip with the silu(z) gate each one kernel
    (``kernels/mamba_mixer``, the same roundings as the plain chain),
    ``xin`` and ``z`` read in place.  Served, each pass launches alone;
    under autograd each is a Function whose backward is one more pass
    (:mod:`~repro_torch.kernels.mamba_mixer.ops`)."""
    with span("mamba.conv"):
        x_conv, xf, xf_gate = mixer_ops.conv_silu(xin, p.conv_w, p.conv_b)
    dt_raw, b, c = _projections(cfg, p, x_conv)
    dt = mixer_ops.dt_softplus(dt_raw, p.dt_bias)
    y = ssm_scan(dt, -torch.exp(p.A_log), b, c, xf)  # (B, S, di) float32
    return _out_proj(mixer_ops.mixer_gate(y, x_conv, xf_gate, p.D, z), p)


def _out_proj(y: torch.Tensor, p: Mamba) -> torch.Tensor:
    return ctx.matmul_psum(y, p.out_proj, ctx.physical_axes("tp"))


def mamba_decode(
    cfg: ModelConfig, p: Mamba, x: torch.Tensor, cache: MambaCache
) -> tuple[torch.Tensor, MambaCache]:
    """One token per sequence, ``x`` (B, 1, D): one step of the
    recurrence from the cache's state.  Writes the new conv window and
    state into ``cache`` in place and returns ``(out (B, 1, D), cache)``."""
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)  # (B, 1, di) each
    x_conv = F.silu(causal_conv(xin, p.conv_w, p.conv_b, cache.conv))
    new_conv = torch.cat([cache.conv[:, 1:], xin.to(cache.conv.dtype)], dim=1)

    dt, a, b, c = _ssm_inputs(cfg, p, x_conv)
    xf = x_conv.float()
    da = torch.exp(dt[:, 0, :, None] * a[None])  # (B, di, N)
    dbx = (dt[:, 0] * xf[:, 0])[..., None] * b[:, 0, None, :]
    h = cache.ssm * da + dbx
    y = torch.einsum("bdn,bn->bd", h, c[:, 0])[:, None]
    out = _out_proj(mixer_gate_ref(y, xf, p.D, z), p)
    cache.conv.copy_(new_conv)
    cache.ssm.copy_(h)
    return out, cache
