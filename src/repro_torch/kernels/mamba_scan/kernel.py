"""Selective scan (mamba-1) as hand-written CUDA kernels for Hopper: the
forward (port of the Pallas kernel ``repro.kernels.mamba_scan.kernel``)
and its backward, which the Pallas kernel does not have.

:func:`selective_scan` launches ``csrc/selective_scan.cu`` on CUDA
tensors: one block per (batch row, tile of channels) walks the sequence
in chunks of steps (:func:`tiles` reads the sizes), each chunk's dt, x, B and C
copied into shared memory by ``cp.async`` a few chunks ahead of the
scan; four lanes share a channel's 16 states, and y leaves in coalesced
tiles (see the source's header for the tiles, their reasons and the
kernel's bound on an H100).  The time axis is not split, so a call is
one launch.  On CPU tensors it runs the plain version
(:func:`~repro_torch.kernels.mamba_scan.ref.selective_scan_ref`).
There is no fallback between the two: a CUDA call that cannot build or
launch the kernel raises.  ``selective_scan.launches`` counts the
kernel's launches.

For training the forward also saves the float32 state entering every time
chunk (``save_states``), and :func:`selective_scan_bwd` launches
``csrc/selective_scan_bwd.cu``: one launch walks the chunks in reverse,
recomputes each chunk's states from the saved one and runs the reverse
recurrence, writing ddt and dx whole and dA, dB and dC as partials that
this wrapper sums in a fixed order (no atomics anywhere, so two calls give
equal bits).  ``selective_scan_bwd.launches`` counts its launches.

On ``meta`` tensors both wrappers allocate what the card's branch would
allocate (the states and partials at the layout :data:`TIME_CHUNK` and
:func:`bwd_slices` give, the sources' own constants) and compute nothing.
Under a recording (``parallel.context.record``) each call, on any
device, adds the work of its bound (:func:`scan_work`,
:func:`scan_bwd_work`).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref, selective_scan_ref
from repro_torch.parallel import context

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
BWD_SOURCE = SOURCE.with_name("selective_scan_bwd.cu")
STATE_WIDTHS = (4, 8, 16)  # d_state values the kernel is instantiated for
# Time steps between the states the forward saves (both sources' kChunk;
# ``tiles`` and ``bwd_layout`` read it from the built libraries).
TIME_CHUNK = 16


def bwd_slices(d_inner: int, d_state: int) -> int:
    """The backward's dB / dC partial slices, one per 32 channels of
    every block of ``512 / d_state`` channels (the source's
    ``Tile<N>::kChannels``; ``bwd_layout`` reads it from the library)."""
    channels = 512 // d_state
    return -(-d_inner // channels) * (channels // 32)


def scan_work(B: int, S: int, di: int, n: int, *, states: bool = False) -> tuple[float, float]:
    """``(operations, bytes)`` of one forward call: 7 operations per (b,
    t, d, n) (dt a, exp, times h, times b, add, times c, add) and one per
    (b, t, d); dt, x, b, c and a read and y written in float32 (and the
    saved chunk states, with ``states``)."""
    elems = B * S * di
    nbytes = 4 * (3 * elems + 2 * B * S * n + di * n)
    if states:
        nbytes += 4 * B * -(-S // TIME_CHUNK) * di * n
    return float(7 * elems * n + elems), float(nbytes)


def scan_bwd_work(B: int, S: int, di: int, n: int) -> tuple[float, float]:
    """``(operations, bytes)`` of one backward call as a function: 26
    operations per (b, t, d, n) (4 in the recomputed forward step, 22 in
    the reverse step); dt, x and dy read and ddt and dx written (B, S,
    di), b and c read and db and dc written (B, S, N), a read and da
    written (di, N), float32."""
    return float(26 * B * S * di * n), float(4 * (5 * B * S * di + 4 * B * S * n + 2 * di * n))


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.selective_scan_fwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.selective_scan_tiles.restype = ctypes.c_int
    lib.selective_scan_tiles.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = build.load(BWD_SOURCE)
    fn = lib.selective_scan_bwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.selective_scan_bwd_layout.restype = ctypes.c_int
    lib.selective_scan_bwd_layout.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.selective_scan_bwd_occupancy.restype = ctypes.c_int
    lib.selective_scan_bwd_occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def bwd_layout(d_inner: int, d_state: int) -> dict[str, int]:
    """The backward kernel's layout: time steps between the states the
    forward saves, and the number of dB / dC partial slices."""
    out = (ctypes.c_int * 2)()
    if _bwd_library().selective_scan_bwd_layout(d_inner, d_state, out) != 0:
        raise ValueError(f"d_state {d_state} has no kernel instantiation {STATE_WIDTHS}")
    return dict(zip(("time_chunk", "slices"), out))


def bwd_occupancy(d_state: int) -> dict[str, int]:
    """The backward kernel's residency on the current card at ``d_state``:
    blocks an SM, registers a thread, dynamic shared bytes a block and
    local (spill) bytes a thread, as the CUDA runtime reports them."""
    out = (ctypes.c_int * 4)()
    rc = _bwd_library().selective_scan_bwd_occupancy(d_state, out)
    if rc != 0:
        raise RuntimeError(f"selective_scan_bwd_occupancy({d_state}) failed: cudaError {rc}")
    return dict(zip(("blocks_per_sm", "registers", "smem_bytes", "local_bytes"), out))


def tiles(d_state: int) -> dict[str, int]:
    """The built kernel's tiling at ``d_state``: time steps a chunk,
    channels a block, ring stages and dynamic shared memory a block."""
    out = (ctypes.c_int * 4)()
    if _library().selective_scan_tiles(d_state, out) != 0:
        raise ValueError(f"d_state {d_state} has no kernel instantiation {STATE_WIDTHS}")
    return dict(zip(("time_chunk", "channels", "stages", "smem_bytes"), out))


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
    *,
    save_states: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor | None]:
    """``y`` (B, S, di) of the selective scan from a zero state.  With
    ``save_states`` returns ``(y, states)``: on a card the float32 state
    entering each time chunk, ``(B, ceil(S / chunk), di, N)``, which
    :func:`selective_scan_bwd` takes; on the CPU ``None`` (the plain
    backward recomputes every state)."""
    B, S, di, n = _check(dt, a, b, c, x)
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"selective_scan runs on cpu, cuda or meta, not {x.device}")
    work = functools.partial(scan_work, B, S, di, n, states=save_states)
    with context.kernel_work("selective_scan", work):
        return _selective_scan(dt, a, b, c, x, save_states)


def _selective_scan(dt, a, b, c, x, save_states: bool):
    """:func:`selective_scan`'s body on x's device."""
    B, S, di, n = x.shape + a.shape[1:]
    if x.device.type == "cpu":
        y = selective_scan_ref(dt, a, b, c, x)[0]
        return (y, None) if save_states else y
    if n not in STATE_WIDTHS:
        raise ValueError(f"d_state {n} has no kernel instantiation {STATE_WIDTHS}")
    y = torch.empty_like(x)
    states = None
    if save_states:
        chunk = TIME_CHUNK if x.device.type == "meta" else tiles(n)["time_chunk"]
        states = torch.empty((B, -(-S // chunk), di, n), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        return (y, states) if save_states else y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.selective_scan_fwd_f32(
            dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            x.data_ptr(), y.data_ptr(), None if states is None else states.data_ptr(),
            B, S, di, n, stream,
        )
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed: cudaError {rc}")
    selective_scan.launches += 1
    return (y, states) if save_states else y


selective_scan.launches = 0


def selective_scan_bwd(
    dt: torch.Tensor,  # (B, S, di) f32
    a: torch.Tensor,  # (di, N) f32
    b: torch.Tensor,  # (B, S, N) f32
    c: torch.Tensor,  # (B, S, N) f32
    x: torch.Tensor,  # (B, S, di) f32
    dy: torch.Tensor,  # (B, S, di) f32: the gradient of y
    states: torch.Tensor | None,  # the forward's saved states (a card) or None (the CPU)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ddt, da, db, dc, dx)`` of :func:`selective_scan`, float32.  On
    CPU tensors the plain version
    (:func:`~repro_torch.kernels.mamba_scan.ref.selective_scan_bwd_ref`);
    on CUDA tensors the kernel, which needs the forward's ``states``."""
    B, S, di, n = _check(dt, a, b, c, x)
    if dy.shape != x.shape or dy.dtype != torch.float32 or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous float32 {tuple(x.shape)} on {x.device}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"selective_scan_bwd runs on cpu, cuda or meta, not {x.device}")
    with context.kernel_work("selective_scan_bwd", functools.partial(scan_bwd_work, B, S, di, n)):
        if x.device.type == "cpu":
            return selective_scan_bwd_ref(dt, a, b, c, x, dy)
        if n not in STATE_WIDTHS:
            raise ValueError(f"d_state {n} has no kernel instantiation {STATE_WIDTHS}")
        if x.device.type == "meta":
            layout = {"time_chunk": TIME_CHUNK, "slices": bwd_slices(di, n)}
        else:
            layout = bwd_layout(di, n)
        want = (B, -(-S // layout["time_chunk"]), di, n)
        if states is None or tuple(states.shape) != want or states.dtype != torch.float32 \
                or states.device != x.device or not states.is_contiguous():
            raise ValueError(f"the CUDA backward needs the forward's float32 states {want}")
        ddt, dx = torch.empty_like(x), torch.empty_like(x)
        da_part = torch.empty((B, di, n), dtype=torch.float32, device=x.device)
        db_part, dc_part = (
            torch.empty((layout["slices"], B, S, n), dtype=torch.float32, device=x.device)
            for _ in range(2)
        )
        if x.device.type == "cuda":
            _launch_bwd(dt, a, b, c, x, dy, states, ddt, dx, da_part, db_part, dc_part)
    # the partials' sums, each in one fixed order
    return ddt, da_part.sum(dim=0), db_part.sum(dim=0), dc_part.sum(dim=0), dx


selective_scan_bwd.launches = 0


def _launch_bwd(dt, a, b, c, x, dy, states, ddt, dx, da_part, db_part, dc_part) -> None:
    B, S, di = x.shape
    lib = _bwd_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.selective_scan_bwd_f32(
            *(t.data_ptr() for t in (dt, a, b, c, x, dy, states, ddt, dx, da_part, db_part,
                                     dc_part)),
            B, S, di, a.shape[1], stream,
        )
    if rc != 0:
        raise RuntimeError(f"selective_scan_bwd launch failed: cudaError {rc}")
    selective_scan_bwd.launches += 1
