"""Without a card, or without the program, a run fails and prints no
result."""

import shutil
import subprocess
import sys

import pytest

from harness.spec import BENCH_DIR, ROOT


def _run(cwd, workload="xor_hmc"):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                           "--seed", "2147483711", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
