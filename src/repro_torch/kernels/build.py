"""Build and bind the port's hand-written CUDA kernels.

Each kernel source under ``kernels/*/csrc/`` exports a plain C entry
point.  At first use it is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library in the
git-ignored ``build/repro_torch_kernels/`` directory of the checkout and
loaded with ``ctypes``; PyTorch's headers are never included, so a build
takes seconds.  The library name carries a digest of the source, so an
edited source never loads a stale library.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: dict[Path, ctypes.CDLL] = {}
# nvcc's report (ptxas registers, spills, shared memory) per built source
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location.  Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def library_path(source: Path) -> Path:
    """Where the shared library built from ``source`` goes."""
    digest = hashlib.blake2b(source.read_bytes(), digest_size=8).hexdigest()
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(source: Path) -> Path:
    """Compile ``source`` into its shared library unless it is already
    built; returns the library's path.  Raises with nvcc's output when the
    compile fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[source.name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built at first use."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _LOADED[source] = lib
        return lib
