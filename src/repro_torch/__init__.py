"""PyTorch/CUDA port of the NUMA bandwidth-model system.

Mirrors ``repro``'s layout module by module (``repro_torch/core/numa/
simulator.py`` is the counterpart of ``repro/core/numa/simulator.py``)
and imports neither JAX nor the JAX package.  Everything computes in
float32, as the reference does with x64 off.

Device rule: every entry point takes an explicit ``device`` whose
default is ``"cuda"``.  Without a CUDA device that default raises
instead of quietly running on the CPU; the CPU runs only when the caller
asks for it (the CPU tests pass ``device="cpu"``).
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` a call runs on.  A CUDA device is checked for
    availability here and raises when there is none; a CUDA device also
    gets full-float32 matmuls (TF32 off), which the progressive fill's
    ``weights @ dense`` products need."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        set_full_float32()
    return dev


def set_full_float32() -> None:
    """Turn TF32 off for matmuls and cuDNN: the port's float32 products
    must round like the reference's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
