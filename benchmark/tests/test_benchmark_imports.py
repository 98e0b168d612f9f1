"""What the benchmark loads: no JAX module and nothing of the JAX package in
a run, nothing of the program in the reference; and the last line's schema."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness
from benchmark.tests.small import run_small

HERE = harness.HERE


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        assert not _imported(path) & {"mage_tpu_torch", *harness.FORBIDDEN}, path
    code = ("import sys; import benchmark.reference.compare, benchmark.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, check=True,
                            capture_output=True, text=True).stdout
    assert "mage_tpu_torch" not in loaded and "'mage_tpu'" not in loaded


def test_the_yardstick_imports_nothing_of_the_program():
    """The counts, the readers and the metrics reckon a kernel's work from
    the configuration, not from the program's objects."""
    files = [*(HERE / "counts").rglob("*.py"), *(HERE / "metrics").glob("*.py")]
    for path in [HERE / "readers.py", *files]:
        assert not _imported(path) & {"mage_tpu_torch", *harness.FORBIDDEN}, path
        assert "mage_tpu_torch" not in path.read_text(), path


def test_no_file_of_the_benchmark_imports_jax():
    for path in sorted(HERE.rglob("*.py")):
        assert not _imported(path) & set(harness.FORBIDDEN), path


def test_a_run_loads_no_jax_module():
    """A whole small run in a fresh process, then the loaded modules'
    top-level names compared whole: ``mage_tpu_torch`` is not ``mage_tpu``."""
    code = ("from benchmark.tests.small import run_small; from benchmark import harness; "
            "run_small('tiny_mage'); print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_last_line_schema(capsys):
    result, checks = run_small("tiny_mage")
    harness.emit(result, checks)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert isinstance(line["correct"], bool)
    assert line["metrics"] and all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    tail = err.strip().splitlines()[-len(checks):]
    assert all(t.startswith("check ") and "limit" in t for t in tail)
