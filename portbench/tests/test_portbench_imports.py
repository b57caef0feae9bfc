"""No module the harness runs imports JAX or the JAX package, and the plain
reference imports nothing of the program under test. Module names are
compared by their top-level name, whole: the port's name begins with the
JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HARNESS = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "channelestimationtransformer_tpu"}
PORT = "channelestimationtransformer_torch"


def top_level_imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports (a relative import
    is the harness's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(HARNESS.name if node.level else node.module.split(".", 1)[0])
    return names


def harness_files():
    return sorted(p for p in HARNESS.rglob("*.py") if "tests" not in p.relative_to(HARNESS).parts)


@pytest.mark.parametrize("path", harness_files(), ids=lambda p: str(p.relative_to(HARNESS)))
def test_no_module_imports_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HARNESS / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in top_level_imports(path)


def test_whole_names_are_compared():
    assert "channelestimationtransformer_tpu" not in {PORT.split(".", 1)[0]}
    from portbench.workload import forbidden_modules

    saved = dict(sys.modules)
    try:
        sys.modules["jax.numpy"] = object()
        sys.modules[f"{PORT}.fake"] = object()
        assert forbidden_modules() == ["jax"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    code = ("import portbench.run, portbench.workload, portbench.calibrate, portbench.faults\n"
            "from portbench.program import Program, launch_counts\n"
            "import channelestimationtransformer_torch.train.trainer\n"
            "import channelestimationtransformer_torch.models.informer\n"
            "import channelestimationtransformer_torch.data.windows\n"
            "launch_counts()\n"
            "from portbench.workload import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=HARNESS.parent, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
