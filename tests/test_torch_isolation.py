"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and its entry points
never fall back to the CPU when the caller did not ask for it."""

import ast
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PORT_DIR)], prefix="repro_torch.")
    )


def test_every_module_imports_without_jax_or_repro():
    """Import every module of the port in a fresh interpreter whose import
    system refuses ``jax`` and ``repro``."""
    modules = _port_modules()
    assert "repro_torch.serve.service" in modules
    assert "repro_torch.kernels.mamba_scan.kernel" in modules
    script = textwrap.dedent(
        f"""
        import importlib, importlib.abc, sys
        sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT)!r}]
        FORBIDDEN = {FORBIDDEN!r}

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
                    raise ImportError("the port must not import " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        for name in {modules!r} + ["chip_smoke"]:
            importlib.import_module(name)
        leaked = [m for m in sys.modules
                  if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
        assert not leaked, leaked
        print("imported", len({modules!r}) + 1)
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120,
        cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(modules) + 1}" in proc.stdout


def test_no_source_file_names_jax_or_repro():
    """Function-level imports too: no import statement of the port's
    sources (or ``chip_smoke.py``) names a forbidden package."""
    files = sorted(PORT_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders


@pytest.fixture
def no_cuda(monkeypatch):
    """A CPU-only process, whatever this machine has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_it(no_cuda):
    from repro_torch.core.numa import E5_2630_V3, mixed_workload, symmetric_placement
    from repro_torch.core.numa.benchmarks import benchmark_workload
    from repro_torch.core.numa.evaluate import enumerate_placements, evaluate_suite
    from repro_torch.serve import AdvisorService

    assert repro_torch.DEFAULT_DEVICE == "cuda"
    calls = [
        lambda: repro_torch.resolve_device(),
        lambda: mixed_workload("w", 4),
        lambda: benchmark_workload("CG", 8),
        lambda: symmetric_placement(E5_2630_V3, 8),
        lambda: enumerate_placements(E5_2630_V3, 8),
        lambda: evaluate_suite(E5_2630_V3),
        lambda: E5_2630_V3.bank_read_caps(),
        lambda: AdvisorService(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cpu_runs_only_on_request(no_cuda):
    from repro_torch.core.numa import mixed_workload

    wl = mixed_workload("w", 4, device="cpu")
    assert wl.device == torch.device("cpu")
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_advisor_cli_defaults_to_cuda(no_cuda):
    """The CLI's default device is the card: without one it fails."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "sys.argv = ['advisor_serve', '--queries', '4']; "
         "from repro_torch.launch.advisor_serve import main; main()"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
