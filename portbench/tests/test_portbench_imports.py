"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port (whole top-level module names: the
port's `saunet_tpu_torch` is not the JAX package's `saunet_tpu`)."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "optax", "saunet_tpu"}


def _top_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax():
    found = {str(p.relative_to(BENCH)): _top_imports(p) & JAX
             for p in BENCH.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}
    assert set(harness.FORBIDDEN) == JAX


def test_reference_imports_nothing_of_the_port():
    for p in (BENCH / "reference").rglob("*.py"):
        assert "saunet_tpu_torch" not in _top_imports(p), p


def test_a_run_leaves_no_jax_module_loaded():
    """A whole cell on the CPU at 32^2 in a fresh process: afterwards
    `sys.modules` holds none of the JAX names, though JAX is installed
    here (the check is not empty by accident)."""
    code = (
        "import importlib.util, sys\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "assert importlib.util.find_spec('jax') is not None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from conftest import small_cell, SERVE_SMALL\n"
        "from portbench import harness\n"
        "cell, run = small_cell('serve-bf16-volumes', **SERVE_SMALL)\n"
        "harness.driver_module(cell['driver']).run(run)\n"
        "print(harness.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=600,
                         env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
