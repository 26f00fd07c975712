"""Random weights from the seed, made by the benchmark on the device in a
few large calls: every ``normal`` leaf is a view into one buffer per dtype
drawn by one ``torch.randn`` from the seed's generator, then scaled; the
other leaves are filled.  The same seed gives the same tensors, so the
reference can be handed them again after the program is gone."""

from __future__ import annotations

import math

import torch

ALIGN = 256  # elements between leaves' starts: every leaf 512-byte aligned or better

def serve_dtype(family, name: str, compute: torch.dtype) -> torch.dtype:
    """The dtype a server holds leaf ``name`` in: float32 for the norm
    scales and the leaves the family (its module) keeps in float32, the
    compute dtype for every other."""
    leaf = name.rsplit(".", 1)[-1]
    return torch.float32 if "norm" in leaf or leaf in family.FLOAT32_SERVED else compute


def make(layout, generator: torch.Generator, dtype_of, device) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``layout`` (a family's), each leaf in
    ``dtype_of(name)``, drawn from ``generator`` (on ``device``)."""
    sizes: dict[torch.dtype, int] = {}
    place = {}
    for name, shape, init in layout:
        if init[0] == "normal":
            dt = dtype_of(name)
            place[name] = sizes.get(dt, 0)
            sizes[dt] = place[name] + -(-math.prod(shape) // ALIGN) * ALIGN
    flat = {dt: torch.randn(n, generator=generator, dtype=dt, device=device)
            for dt, n in sizes.items()}
    out = {}
    with torch.no_grad():
        for name, shape, init in layout:
            dt = dtype_of(name)
            if init[0] == "normal":
                t = flat[dt][place[name]:place[name] + math.prod(shape)].view(shape)
                out[name] = t.mul_(init[1])
            elif init[0] == "fill":
                out[name] = torch.full(shape, init[1], dtype=dt, device=device)
            elif init[0] == "log_arange":
                row = torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32, device=device))
                out[name] = row.expand(shape).to(dt).contiguous()
            else:
                raise ValueError(f"{name}: unknown init {init}")
    return out
