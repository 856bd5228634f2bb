"""What the benchmark imports: nothing it runs imports JAX or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), the reference imports nothing of the port, and nothing reads
the JAX benchmark's folder or bench.py."""

import ast

import pytest

from harness.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "eeyore_tpu"}
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def imported_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_or_jax_package(path):
    tops = {name.split(".")[0] for name in imported_names(path)}
    assert not tops & FORBIDDEN
    assert path.stem.split(".")[0] not in FORBIDDEN


def test_whole_name_comparison():
    tops = {name.split(".")[0] for name in imported_names(BENCH_DIR / "harness" / "program.py")}
    assert "eeyore_tpu_torch" in tops and "eeyore_tpu" not in tops


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in imported_names(path)}
    assert tops <= {"math", "torch", "numpy", "reference"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_reads_nothing_of_the_jax_benchmark(path):
    text = path.read_text()
    assert "benchmarks/" not in text and "bench.py" not in text


def test_run_loads_no_jax(tmp_path):
    import subprocess
    import sys

    code = ("import sys; sys.argv=['run.py']; sys.path.insert(0, %r); import run; "
            "from harness import check, program, trace; import eeyore_tpu_torch; "
            "print(run.forbidden_modules())") % str(BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
