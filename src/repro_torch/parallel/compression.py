"""Gradient compression: an int8 exchange with error feedback (port of
``repro.parallel.compression``).

The data-parallel gradient reduction is the largest recurring collective
in training.  Replacing the float32 all-reduce with an int8
reduce-scatter and all-gather cuts its link bytes about 4x:

    all-reduce fp32 ring:  2 * (k-1)/k * 4B per element
    int8 RS + int8 AG:     2 * (k-1)/k * 1B per element (+ scales)

Quantization is per-tensor symmetric (scale ``max|x| / 127``, rounded
half to even as ``jnp.round``), with an error-feedback residual that the
caller carries between steps, so the quantization error is re-injected
next step rather than lost.  The collectives are ``torch.distributed``'s
on int8 tensors: ``all_to_all_single`` for the reduce-scatter and
``all_gather`` for the rest.  As in the reference, no training step calls
it; both functions are the identity with no mesh or over one rank.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.optim.adamw import _map
from repro_torch.parallel import context as ctx


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_mean(x: torch.Tensor, axis_names: tuple[str, ...]) -> torch.Tensor:
    """The mean over ``axis_names`` of a float32 tensor, exchanged as int8:
    the flattened tensor in ``k`` chunks (zero-padded), quantized; an
    all-to-all gives each rank every rank's copy of its chunk, which it
    dequantizes and sums in float32; the sum is quantized again and
    all-gathered.  ``x`` itself over one rank."""
    mesh = ctx.current_mesh()
    k = 1 if mesh is None else mesh.axes_size(axis_names)
    if k == 1:
        return x
    shape, n = x.shape, x.numel()
    pad = (-n) % k
    chunks = F.pad(x.reshape(-1), (0, pad)).reshape(k, (n + pad) // k)

    q, scale = _quantize(chunks)
    # reduce-scatter: row i of ``swapped`` is rank i's copy of this rank's chunk
    swapped = ctx.all_to_all(q, axis_names)
    scales = ctx.all_gather(scale[None], axis_names, 0, adjoint="slice")
    parts = swapped.float() * scales[:, None]
    local_sum = parts[0]
    for part in parts[1:]:
        local_sum = local_sum + part
    q2, scale2 = _quantize(local_sum)
    gathered = ctx.all_gather(q2[None], axis_names, 0, adjoint="slice")  # (k, chunk) int8
    scales2 = ctx.all_gather(scale2[None], axis_names, 0, adjoint="slice")
    full = (gathered.float() * scales2[:, None]).reshape(-1)
    return full[:n].reshape(shape) / k


def compressed_grad_mean(grads: Any, residual: Any | None = None) -> tuple[Any, Any]:
    """Error-feedback compressed data-parallel gradient mean: each leaf
    plus its residual, averaged over the ``dp_all`` axes with int8 wire
    traffic; the new residual is what the quantization lost here.
    Returns ``(mean_grads, new_residual)``, the residual zeros (float32)
    when none is given.  With no mesh or no data axis it returns its
    arguments."""
    axes = ctx.physical_axes("dp_all")
    if ctx.current_mesh() is None or not axes:
        return grads, residual
    if residual is None:
        residual = _map(lambda _, g: torch.zeros_like(g, dtype=torch.float32), grads)

    pairs = {}

    def one(path, g, r):
        with_fb = g.float() + r
        reduced = compressed_psum_mean(with_fb, axes)
        pairs[path] = with_fb - reduced  # the local quantization error, re-injected
        return reduced.to(g.dtype)

    mean = _map(one, grads, residual)
    return mean, _map(lambda path, _: pairs[path], grads)
