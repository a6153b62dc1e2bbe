"""What the harness loads: nothing of JAX or the JAX package, in a run's
process or in its sources; and a reference that imports nothing of the
program."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "recognizer3d_tpu"}


def _imported(path: Path):
    """Top-level names of every module a source file imports."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_harness_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        found = set(_imported(path)) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        names = set(_imported(path))
        assert "recognizer3d_tpu_torch" not in names, path
        assert not names & FORBIDDEN, path


def test_a_run_process_loads_no_jax_module():
    # every module the harness reaches: its entry points, drivers, metrics
    # and counts, and the program they drive
    code = (
        "import sys, importlib, pathlib\n"
        "import portbench.run, portbench.control\n"
        "from portbench import drivers, run\n"
        "from recognizer3d_tpu_torch.models import facade\n"
        "for p in sorted(pathlib.Path('portbench/counts').glob('*.py')):\n"
        "    importlib.import_module('portbench.counts.' + p.stem)\n"
        "r = run.Reading({}, {}, [], 1)\n"
        "for p in sorted(pathlib.Path('portbench/metrics').glob('*.py')):\n"
        "    run.read_metric(p.name[:-3], r)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))  # noqa: S307 — our own print
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "recognizer3d_tpu_torch" in loaded
