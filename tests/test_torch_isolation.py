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
    assert "repro_torch.kernels.flash_attention.kernel" in modules
    assert "repro_torch.launch.serve" in modules
    assert {"repro_torch.models.mamba", "repro_torch.models.moe"} <= set(modules)
    assert {
        "repro_torch.optim.adamw",
        "repro_torch.core.numa.search",
        "repro_torch.core.numa.temporal",
        "repro_torch.core.meshsig.advisor",
        "repro_torch.core.meshsig.device_topology",
        "repro_torch.core.meshsig.counters",
        "repro_torch.core.meshsig.fit",
        "repro_torch.core.meshsig.calibrate",
        "repro_torch.core.numa.calibrate",
        "repro_torch.serve.faults",
        "repro_torch.serve.recalibrate",
        "repro_torch.launch.train",
        "repro_torch.data.pipeline",
        "repro_torch.checkpoint.store",
        "repro_torch.runtime.fault_tolerance",
        "repro_torch.parallel.context",
        "repro_torch.launch.mesh",
        "repro_torch.launch.dryrun",
        "repro_torch.core.meshsig.validate",
    } <= set(modules)
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


def test_dry_run_and_validation_set_no_environment_at_import():
    """The reference's ``dryrun`` and ``validate`` set ``XLA_FLAGS`` when
    imported; the port's set nothing: a fresh interpreter's environment is
    the same after importing them, and no source of the port writes
    ``os.environ``."""
    script = textwrap.dedent(
        f"""
        import os, sys
        sys.path[:0] = [{str(ROOT / "src")!r}]
        before = dict(os.environ)
        import repro_torch.launch.dryrun, repro_torch.core.meshsig.validate
        import repro_torch.core.meshsig.counters
        assert dict(os.environ) == before, set(os.environ.items()) ^ set(before.items())
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
        print("clean")
        """
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout
    writes = []
    for path in sorted(PORT_DIR.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            target = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                target = next((t for t in targets if isinstance(t, ast.Subscript)), None)
                target = target and target.value
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("setdefault", "update", "putenv"):
                target = node.func if node.func.attr == "putenv" else node.func.value
            if target is not None and ("environ" in ast.unparse(target)
                                       or ast.unparse(target).endswith("putenv")):
                writes.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not writes, writes


@pytest.fixture
def no_cuda(monkeypatch):
    """A CPU-only process, whatever this machine has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_it(no_cuda):
    from repro_torch.core.numa import (
        E5_2630_V3,
        collect_sweep,
        fit_from_simulated,
        mixed_workload,
        probe_suite,
        symmetric_placement,
    )
    from repro_torch.core.numa.benchmarks import benchmark_workload
    from repro_torch.core.numa.evaluate import enumerate_placements, evaluate_suite
    from repro_torch.configs.base import get_config
    from repro_torch.core.meshsig import calibrate as mesh_cal
    from repro_torch.core.meshsig.device_topology import nvlink_island
    from repro_torch.data.pipeline import TokenStream, synthetic_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.serve import AdvisorService

    cfg = get_config("llama3-8b").reduced()
    cpu_params = M.init_params(cfg, torch.Generator(), device="cpu")
    prompts = torch.zeros((1, 4), dtype=torch.int32)
    island = nvlink_island(4)
    charges = mesh_cal.probe_suite(island)
    cpu_samples = mesh_cal.collect_samples(island, charges, device="cpu")
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
        lambda: probe_suite(E5_2630_V3),
        lambda: collect_sweep(E5_2630_V3),
        lambda: fit_from_simulated(E5_2630_V3, steps=1),
        lambda: mesh_cal.collect_samples(island, charges),
        lambda: mesh_cal.fit_device_topology(island, cpu_samples, steps=1),
        lambda: mesh_cal.fit_from_synthetic(island, steps=1),
        lambda: M.init_params(cfg, torch.Generator()),
        lambda: M.init_cache(cfg, 1, 8, torch.bfloat16),
        lambda: generate(cfg, cpu_params, prompts, 6, 2),
        lambda: TokenStream(cfg, 8, 2),
        lambda: synthetic_batch(cfg, 8, 2, torch.Generator()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cpu_runs_only_on_request(no_cuda):
    from repro_torch.core.meshsig.calibrate import fit_from_synthetic
    from repro_torch.core.meshsig.device_topology import nvlink_island
    from repro_torch.core.numa import mixed_workload

    wl = mixed_workload("w", 4, device="cpu")
    assert wl.device == torch.device("cpu")
    fit = fit_from_synthetic(nvlink_island(4), steps=2, device="cpu")
    assert fit.loss_history.shape == (2,)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def _cli_without_cuda(module: str, args: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         f"sys.argv = [{module!r}, *{args!r}]; "
         f"from repro_torch.launch.{module} import main; main()"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )


def test_advisor_cli_defaults_to_cuda(no_cuda):
    """The CLI's default device is the card: without one it fails."""
    proc = _cli_without_cuda("advisor_serve", ["--queries", "4"])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_serve_cli_defaults_to_cuda(no_cuda):
    proc = _cli_without_cuda("serve", ["--reduced", "--gen", "2"])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_train_cli_defaults_to_cuda(no_cuda, tmp_path):
    proc = _cli_without_cuda("train", ["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
