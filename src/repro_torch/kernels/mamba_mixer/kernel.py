"""The mamba-1 mixer's prefill passes around K2 as hand-written CUDA
kernels for Hopper: the causal conv with its SiLU, the dt softplus, and
the D skip with the silu(z) gate (``csrc/mamba_mixer.cu``, one library,
one launch a pass).

They replace no Pallas kernel: the reference leaves this chain to XLA.
Each pass is bytes-bound; the source's header states the bound and what
the design does about it.  On CPU tensors each wrapper runs its plain
version (:mod:`~repro_torch.kernels.mamba_mixer.ref`); on CUDA tensors it
launches its kernel or raises, with no fallback between the two.  Each
wrapper's ``launches`` counts its kernel's launches.

On a card the wrappers take exactly what the kernels take (the model's
layout: the x and z halves of ``in_proj``'s output as strided views with
a contiguous last dim, everything else contiguous; bfloat16 or float32
compute) and raise on anything else;
:mod:`~repro_torch.kernels.mamba_mixer.ops` adapts the model's leaves.
No pass is differentiable: the model's training path keeps the plain
chain.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_mixer.ref import conv_silu_ref, dt_softplus_ref, mixer_gate_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_mixer.cu"
CONV_WIDTHS = (4,)  # conv widths the conv pass is instantiated for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # compute dtypes, as the C entries number them
_MAX_BATCH = 65535  # the conv's grid takes the batch as its z dimension


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        "mixer_conv_silu": [ptr] * 5 + [i32] * 4 + [i64] * 2 + [i32, ptr],
        "mixer_dt_softplus": [ptr] * 3 + [i32] * 3 + [ptr],
        "mixer_gate": [ptr] * 5 + [i32] * 3 + [i64] * 2 + [i32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = argtypes
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device, *, contiguous=True) -> None:
    """Shape, dtype and device; on a card also the layout the kernel reads
    (contiguous, or with ``contiguous=False`` a contiguous last dim)."""
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if device.type != "cuda":
        return
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not contiguous and t.numel() and t.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous last dimension, got strides {t.stride()}")


def _compute_dtype(t: torch.Tensor) -> int:
    if t.dtype not in DTYPES:
        raise TypeError(f"the mixer passes compute in {tuple(DTYPES)}, not {t.dtype}")
    return DTYPES[t.dtype]


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the mixer passes run on cpu or cuda, not {t.device}")
    return t.device.type


def _run(name: str, device: torch.device, *args) -> None:
    """Launch C entry ``name`` on ``device``'s current stream; raises on a
    refused launch."""
    fn = getattr(_library(), name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def conv_silu(
    xin: torch.Tensor,  # (B, S, di), compute dtype: a view of in_proj's output
    w: torch.Tensor,  # (K, di), compute dtype
    b: torch.Tensor,  # (di,), compute dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x_conv, xf)``: the causal depthwise conv of ``xin`` from zero
    history, its SiLU rounded to the compute dtype (contiguous), and that
    value widened to float32."""
    dtype = _compute_dtype(xin)
    if xin.dim() != 3:
        raise ValueError(f"xin must be (B, S, di), got {tuple(xin.shape)}")
    B, S, di = xin.shape
    _check("xin", xin, (B, S, di), xin.dtype, xin.device, contiguous=False)
    _check("w", w, (w.shape[0], di), xin.dtype, xin.device)
    _check("b", b, (di,), xin.dtype, xin.device)
    if _device(xin) == "cpu":
        return conv_silu_ref(xin, w, b)
    if w.shape[0] not in CONV_WIDTHS:
        raise ValueError(f"conv width {w.shape[0]} has no kernel instantiation {CONV_WIDTHS}")
    if B > _MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the conv pass's grid ({_MAX_BATCH})")
    out = torch.empty((B, S, di), dtype=xin.dtype, device=xin.device)
    out_f32 = torch.empty((B, S, di), dtype=torch.float32, device=xin.device)
    if xin.numel():
        _run("mixer_conv_silu", xin.device, xin.data_ptr(), w.data_ptr(), b.data_ptr(),
             out.data_ptr(), out_f32.data_ptr(), B, S, di, w.shape[0], xin.stride(0),
             xin.stride(1), dtype)
        conv_silu.launches += 1
    return out, out_f32


conv_silu.launches = 0


def dt_softplus(
    dt_raw: torch.Tensor,  # (B, S, di), compute dtype, contiguous: dt @ dt_proj
    dt_bias: torch.Tensor,  # (di,) float32
) -> torch.Tensor:
    """``dt`` (B, S, di) float32: softplus of ``dt_raw`` plus the bias
    rounded to the compute dtype, the sum and the softplus rounded to it
    too, then widened."""
    dtype = _compute_dtype(dt_raw)
    if dt_raw.dim() != 3:
        raise ValueError(f"dt_raw must be (B, S, di), got {tuple(dt_raw.shape)}")
    B, S, di = dt_raw.shape
    _check("dt_raw", dt_raw, (B, S, di), dt_raw.dtype, dt_raw.device)
    _check("dt_bias", dt_bias, (di,), torch.float32, dt_raw.device)
    if _device(dt_raw) == "cpu":
        return dt_softplus_ref(dt_raw, dt_bias)
    dt = torch.empty((B, S, di), dtype=torch.float32, device=dt_raw.device)
    if dt.numel():
        _run("mixer_dt_softplus", dt_raw.device, dt_raw.data_ptr(), dt_bias.data_ptr(),
             dt.data_ptr(), B * S, di, dtype)
        dt_softplus.launches += 1
    return dt


dt_softplus.launches = 0


def mixer_gate(
    y: torch.Tensor,  # (B, S, di) float32, contiguous: K2's output
    x_conv: torch.Tensor,  # (B, S, di), compute dtype, contiguous
    D: torch.Tensor,  # (di,) float32
    z: torch.Tensor,  # (B, S, di), compute dtype: a view of in_proj's output
) -> torch.Tensor:
    """``(y + float(x_conv) D) silu(float(z))`` in float32, rounded to the
    compute dtype: (B, S, di), contiguous."""
    dtype = _compute_dtype(x_conv)
    if x_conv.dim() != 3:
        raise ValueError(f"x_conv must be (B, S, di), got {tuple(x_conv.shape)}")
    B, S, di = x_conv.shape
    _check("y", y, (B, S, di), torch.float32, x_conv.device)
    _check("x_conv", x_conv, (B, S, di), x_conv.dtype, x_conv.device)
    _check("D", D, (di,), torch.float32, x_conv.device)
    _check("z", z, (B, S, di), x_conv.dtype, x_conv.device, contiguous=False)
    if _device(x_conv) == "cpu":
        return mixer_gate_ref(y, x_conv.float(), D, z)
    out = torch.empty((B, S, di), dtype=x_conv.dtype, device=x_conv.device)
    if out.numel():
        _run("mixer_gate", x_conv.device, y.data_ptr(), x_conv.data_ptr(), D.data_ptr(),
             z.data_ptr(), out.data_ptr(), B, S, di, z.stride(0), z.stride(1), dtype)
        mixer_gate.launches += 1
    return out


mixer_gate.launches = 0
