"""Nothing under ``portbench/`` imports JAX or the JAX package ``repro``
(module names compared by their whole top-level part, so the port
``repro_torch`` is not taken for ``repro``), and nothing under
``portbench/reference/`` imports the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(PORTBENCH.rglob("*.py"))


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_no_jax_in_the_benchmark(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PORTBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch"})


def test_whole_top_level_names():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN


def test_a_run_holds_no_jax():
    """Every module of the benchmark and the port's modules a cell runs,
    imported in a fresh process: no JAX and no ``repro`` in
    ``sys.modules``."""
    modules = sorted({".".join(p.relative_to(PORTBENCH.parent).with_suffix("").parts)
                      for p in FILES if "tests" not in p.parts and p.name != "run.py"})
    code = ("import sys\n"
            f"sys.path[:0] = [{str(PORTBENCH.parent / 'src')!r}, {str(PORTBENCH.parent)!r}]\n"
            "import importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "import repro_torch.launch.steps, repro_torch.models.model\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(FORBIDDEN)!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
