"""Selective scan (mamba-1) forward as a hand-written CUDA kernel for
Hopper (port of the Pallas kernel ``repro.kernels.mamba_scan.kernel``).

:func:`selective_scan` launches ``csrc/selective_scan.cu`` (one thread
per (batch, channel), the N-wide state in registers, the time loop
inside the thread; see the source's header for its design and its bound
on an H100) on CUDA tensors, and runs the plain version
(:func:`~repro_torch.kernels.mamba_scan.ref.selective_scan_ref`) on CPU
tensors.  There is no fallback between the two: a CUDA call that cannot
build or launch the kernel raises.  ``selective_scan.launches`` counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
STATE_WIDTHS = (4, 8, 16)  # d_state values the kernel is instantiated for


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.selective_scan_fwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def _check(dt, a, b, c, x) -> tuple[int, int, int, int]:
    """Validate the kernel's inputs; returns ``(B, S, di, N)``."""
    names = ("dt", "a", "b", "c", "x")
    tensors = (dt, a, b, c, x)
    for name, t in zip(names, tensors):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, di), got {tuple(x.shape)}")
    B, S, di = x.shape
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"a must be ({di}, N), got {tuple(a.shape)}")
    n = a.shape[1]
    expect = {"dt": (B, S, di), "b": (B, S, n), "c": (B, S, n)}
    for name, t in (("dt", dt), ("b", b), ("c", c)):
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} must be {expect[name]}, got {tuple(t.shape)}")
    return B, S, di, n


def selective_scan(
    dt: torch.Tensor,  # (B, S, di) f32
    a: torch.Tensor,  # (di, N) f32
    b: torch.Tensor,  # (B, S, N) f32
    c: torch.Tensor,  # (B, S, N) f32
    x: torch.Tensor,  # (B, S, di) f32
) -> torch.Tensor:
    """``y`` (B, S, di) of the selective scan from a zero state."""
    B, S, di, n = _check(dt, a, b, c, x)
    if x.device.type == "cpu":
        return selective_scan_ref(dt, a, b, c, x)[0]
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, not {x.device}")
    if n not in STATE_WIDTHS:
        raise ValueError(f"d_state {n} has no kernel instantiation {STATE_WIDTHS}")
    lib = _library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.selective_scan_fwd_f32(
            dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            x.data_ptr(), y.data_ptr(), B, S, di, n, stream,
        )
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed: cudaError {rc}")
    selective_scan.launches += 1
    return y


selective_scan.launches = 0
