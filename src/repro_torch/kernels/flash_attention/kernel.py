"""Flash attention as hand-written CUDA kernels for Hopper: the forward
(port of the Pallas kernel ``repro.kernels.flash_attention.kernel``) and
its backward, which the Pallas kernel does not have.

:func:`flash_attention` launches one of two kernels on CUDA tensors,
chosen by the inputs' dtype as the design, not as a fallback:

- bfloat16: ``csrc/flash_attention_bf16.cu``, on the tensor cores (wgmma
  fed by TMA loads into a two-stage ring, a producer warpgroup and two
  consumer warpgroups of 64 q rows; probabilities rounded to bf16 for
  the P V product);
- float32: ``csrc/flash_attention.cu``, on CUDA cores (every product in
  float32, which the 2e-5 parity tolerance asks for).

Both run one block per (q tile, q-head, batch) with the KV walk a loop
inside the block and float32 running max, sum and accumulator; each
source's header states its design and its bound on an H100.  On CPU
tensors the wrapper runs the plain version
(:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`).  A
CUDA call that cannot build or launch its kernel raises.
``flash_attention.launches`` counts the kernels' launches.

The kernels read their operands through (batch, head, seq) strides, so
views of the model's (B, S, H, dh) tensors, transposed to (B, H, S, dh),
go in without a copy; dh must be contiguous, and for bfloat16 (TMA) the
base addresses and the strides in bytes must be multiples of 16.  For
training the forward also writes the float32 row log-sum-exp (``lse``),
from which :func:`flash_attention_bwd` recomputes the probabilities;
serving passes none.  The backward, too, has two kernels chosen by dtype
(``BWD_SOURCES``), both without atomics:

- bfloat16: ``csrc/flash_attention_bwd_bf16.cu``, on the tensor cores
  (wgmma fed by TMA, the forward's producer and consumer warpgroups; a
  dK/dV pass per KV tile summing the GQA group and a dQ pass per q tile);
  every operand and gradient buffer needs the forward's 16-byte rule;
- float32: ``csrc/flash_attention_bwd.cu``, on CUDA cores.

``flash_attention_bwd.launches`` counts its calls, each of which launches
three kernels (D = rowsum(dO O), dK and dV, dQ).

On ``meta`` tensors both wrappers allocate what the card's branch would
allocate and compute nothing (a counted ``meta`` run,
``core.meshsig.counters``).  Under a recording
(``parallel.context.record``) each call, on any device, adds its work:
4 dh operations per visible (row, column) pair (:func:`attention_pairs`)
forward and 2.5 times that backward, and its operands' and results'
bytes (:func:`flash_work`).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)
from repro_torch.parallel import context

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    torch.bfloat16: CSRC / "flash_attention_bf16.cu",
    torch.float32: CSRC / "flash_attention.cu",
}
BWD_SOURCES = {
    torch.bfloat16: CSRC / "flash_attention_bwd_bf16.cu",
    torch.float32: CSRC / "flash_attention_bwd.cu",
}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # dh values every kernel takes
_TMA_ALIGN = 16  # bytes: TMA's alignment of base addresses and strides


@functools.lru_cache(maxsize=256)
def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (row, col) pairs one (batch, head) of attention must compute:
    those its mask leaves visible (right-aligned rows)."""
    rows = np.arange(sq) + (skv - sq)
    hi = np.minimum(rows + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(rows - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def flash_work(q: torch.Tensor, k: torch.Tensor, *, causal: bool, window: int,
               lse: bool = False, backward: bool = False) -> tuple[float, float]:
    """``(operations, bytes)`` of one call on ``q`` (B, H, Sq, dh) and
    ``k`` (B, Kv, Skv, dh): 4 dh operations per visible pair (QK^T and
    PV), 2.5 times that for the backward; the forward reads q, k and v
    and writes o (and, with ``lse``, the float32 log-sum-exp), the
    backward reads q, k, v, o, dO and the log-sum-exp and writes dq, dk
    and dv."""
    B, H, sq, dh = q.shape
    ops = 4 * dh * B * H * attention_pairs(sq, k.shape[2], causal, window)
    qb, kb, lse_b = q.numel() * q.element_size(), k.numel() * k.element_size(), 4 * B * H * sq
    if backward:
        return 2.5 * ops, 4 * qb + 4 * kb + lse_b
    return float(ops), 2 * qb + 2 * kb + (lse_b if lse else 0)


def _check_layout(tensors: dict, dh: int) -> None:
    """What every kernel of a device branch needs of its operands."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} has no kernel instantiation {HEAD_DIMS}")
    for name, t in tensors.items():
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")


def _library(dtype: torch.dtype) -> ctypes.CDLL:
    lib = build.load(SOURCES[dtype])
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        + [ctypes.c_void_p] * 2
    )
    return lib


def _bwd_library(dtype: torch.dtype) -> ctypes.CDLL:
    lib = build.load(BWD_SOURCES[dtype])
    fn = lib.flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    return lib


def _tma_aligned(t: torch.Tensor) -> bool:
    byte_strides = (st * t.element_size() for st in t.stride()[:3])
    return all(x % _TMA_ALIGN == 0 for x in (t.data_ptr(), *byte_strides))


def _check_tma(name: str, t: torch.Tensor) -> None:
    if not _tma_aligned(t):
        raise ValueError(
            f"{name}: the bf16 kernels' TMA loads need a {_TMA_ALIGN}-byte-aligned base "
            f"and strides, got {t.data_ptr() % _TMA_ALIGN} bytes off and strides {t.stride()}"
        )


def _check(q, k, v, out) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d (B, heads, S, dh), got {tuple(t.shape)}")
        if t.dtype not in SOURCES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is {q.dtype} on {q.device}")
    B, H, _, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} q-heads are not a multiple of {k.shape[1]} kv-heads")
    if out is not None and (
        out.shape != q.shape or out.dtype != q.dtype or out.device != q.device
    ):
        raise ValueError(f"out must be {tuple(q.shape)} {q.dtype} on {q.device}")


def flash_attention(
    q: torch.Tensor,  # (B, H, Sq, dh)
    k: torch.Tensor,  # (B, Kv, Skv, dh)
    v: torch.Tensor,  # (B, Kv, Skv, dh)
    *,
    causal: bool = True,
    window: int = 0,
    logit_cap: float = 0.0,
    out: torch.Tensor | None = None,  # (B, H, Sq, dh), written in place
    lse: torch.Tensor | None = None,  # (B, H, Sq) float32, written in place
) -> torch.Tensor:
    """Attention output ``(B, H, Sq, dh)`` in q's dtype (``out`` when
    given).  Queries are right-aligned: row ``r`` sits at position
    ``r + Skv - Sq``.  With ``lse`` (contiguous float32) the kernel also
    writes each row's log-sum-exp of its scaled, capped, masked scores,
    which :func:`flash_attention_bwd` takes."""
    _check(q, k, v, out)
    if lse is not None and (
        lse.shape != q.shape[:3] or lse.dtype != torch.float32 or lse.device != q.device
        or not lse.is_contiguous()
    ):
        raise ValueError(f"lse must be contiguous float32 {tuple(q.shape[:3])} on {q.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu, cuda or meta, not {q.device}")
    work = functools.partial(flash_work, q, k, causal=causal, window=window, lse=lse is not None)
    with context.kernel_work("flash_attention", work):
        return _flash_attention(q, k, v, causal, window, logit_cap, out, lse)


def _flash_attention(q, k, v, causal, window, logit_cap, out, lse) -> torch.Tensor:
    """:func:`flash_attention`'s body on q's device."""
    if q.device.type == "cpu":
        result = attention_ref(q, k, v, causal=causal, window=window, logit_cap=logit_cap)
        if lse is not None:
            lse.copy_(attention_lse_ref(q, k, causal=causal, window=window, logit_cap=logit_cap))
        return result if out is None else out.copy_(result)
    B, H, Sq, dh = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _check_layout({"q": q, "k": k, "v": v, "out": out}, dh)
    if q.device.type == "meta":
        return out
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            _check_tma(name, t)
    lib = _library(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Kv, Sq, Skv, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            dh**-0.5, int(causal), int(window), float(logit_cap),
            None if lse is None else lse.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,  # (B, H, Sq, dh)
    k: torch.Tensor,  # (B, Kv, Skv, dh)
    v: torch.Tensor,  # (B, Kv, Skv, dh)
    out: torch.Tensor,  # (B, H, Sq, dh): the forward's output
    dout: torch.Tensor,  # (B, H, Sq, dh): its gradient
    lse: torch.Tensor | None,  # (B, H, Sq) float32: the forward's log-sum-exp
    *,
    causal: bool = True,
    window: int = 0,
    logit_cap: float = 0.0,
    grads: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention`, in the inputs' dtype
    (``grads``, three tensors shaped as q, k and v, are written in place
    when given).  On CPU tensors the plain version
    (:func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_ref`)
    recomputes the forward and ignores ``out`` and ``lse``; on CUDA
    tensors the kernel needs both."""
    _check(q, k, v, out)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must be {tuple(q.shape)} {q.dtype} on {q.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention_bwd runs on cpu, cuda or meta, not {q.device}")
    work = functools.partial(flash_work, q, k, causal=causal, window=window, backward=True)
    with context.kernel_work("flash_attention_bwd", work):
        return _flash_attention_bwd(q, k, v, out, dout, lse, causal, window, logit_cap, grads)


def _flash_attention_bwd(q, k, v, out, dout, lse, causal, window, logit_cap, grads):
    """:func:`flash_attention_bwd`'s body on q's device."""
    if q.device.type == "cpu":
        result = attention_bwd_ref(q, k, v, dout, causal=causal, window=window,
                                   logit_cap=logit_cap)
        if grads is None:
            return result
        return tuple(g.copy_(r) for g, r in zip(grads, result))
    B, H, Sq, dh = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    if lse is None or lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("the CUDA backward needs the forward's contiguous float32 lse")
    if grads is None:
        grads = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                      for t in (q, k, v))
    for want, g in zip((q, k, v), grads):
        if g.shape != want.shape or g.dtype != q.dtype or g.device != q.device:
            raise ValueError(f"gradient buffer {tuple(g.shape)} {g.dtype} does not fit")
    tensors = (q, k, v, out, dout, *grads)
    _check_layout(dict(zip(("q", "k", "v", "out", "dout", "dq", "dk", "dv"), tensors)), dh)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return grads
    if q.dtype == torch.bfloat16:
        for name, t in zip(("q", "k", "v", "out", "dout", "dq", "dk", "dv"), tensors):
            _check_tma(name, t)
    ptrs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in tensors))
    strides = (ctypes.c_longlong * 24)(*(st for t in tensors for st in t.stride()[:3]))
    lib = _bwd_library(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            ptrs, strides, lse.data_ptr(), delta.data_ptr(),
            int(q.dtype == torch.bfloat16), B, H, Kv, Sq, Skv, dh,
            dh**-0.5, int(causal), int(window), float(logit_cap), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError {rc}")
    flash_attention_bwd.launches += 1
    return grads


flash_attention_bwd.launches = 0
