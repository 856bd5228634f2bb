"""Port, the examples: every script of ``examples_torch/`` (the counterpart of
``examples/``, subfolder for subfolder) runs its ``main(device="cpu")`` to
its end at a small size, in process, and every statistic it prints and
returns is finite; ``parallel/multichip.py`` runs as two Gloo processes on
the CPU at its own sizes, as its docstring says to run it."""

import importlib.util
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from chip_smoke import numbers

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"
# each example's small size on the CPU
SIZES = {
    "mlp/iris_mala.py": dict(num_epochs=1300, num_burnin_epochs=100),
    "mlp/xor_hmc_many_chains.py": dict(num_chains=64, num_iters=60, burnin=20),
    "mlp/xor_kernel_backends.py": dict(num_chains=64, num_epochs=40, burnin_epochs=20,
                                       probe_warmup=20),
    "mlp/xor_resident_kernels.py": dict(num_chains=1024, num_iters=8, burnin=4,
                                        staged_block=256, dense_block=1024),
    "mlp/xor_smc.py": dict(num_particles=512),
    "mlp/xor_smc_adaptive.py": dict(num_particles=1024),
    "distributions/bivariate_normal.py": dict(num_iters=600, num_burnin_iters=100),
    "distributions/bivariate_normal_mixture.py": dict(num_iters=600, num_burnin_iters=100),
    "distributions/gamma.py": dict(num_iters=600, num_burnin_iters=100),
    "distributions/nuts_fixed_budget.py": dict(num_chains=16, num_iters=40, num_burnin_iters=10,
                                               probe_warmup=20),
    "logistic_regression/banknotes.py": dict(num_iters=600, num_burnin_iters=100),
    "stats/diagnostics.py": dict(num_iters=1000),
}
NON_FINITE = re.compile(r"\b(nan|inf)\b", re.IGNORECASE)


def load(relative):
    spec = importlib.util.spec_from_file_location(
        "example_" + relative.replace("/", "_")[:-3], EXAMPLES / relative)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_example_is_listed():
    scripts = sorted(str(p.relative_to(EXAMPLES)) for p in EXAMPLES.rglob("*.py"))
    jax_scripts = sorted(str(p.relative_to(EXAMPLES.parent / "examples"))
                         for p in (EXAMPLES.parent / "examples").rglob("*.py"))
    assert scripts == jax_scripts == sorted([*SIZES, "parallel/multichip.py"])


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("relative", [*SIZES, "parallel/multichip.py"])
def test_example_runs_with_finite_statistics(relative, capsys, one_thread, tmp_path):
    if relative == "parallel/multichip.py":
        out = run_two_ranks(tmp_path)
        assert len(re.findall(r"log-evidence -?\d", out)) == 2, out
    else:
        stats = load(relative).main(device="cpu", **SIZES[relative])
        out = capsys.readouterr().out
        values = numbers(stats)
        assert values and all(math.isfinite(v) for v in values), stats
    assert out.strip() and not NON_FINITE.search(out), out


def run_two_ranks(tmp_path):
    """multichip.py as two Gloo ranks on the CPU; their joined output."""
    procs = [subprocess.Popen(
        [sys.executable, str(EXAMPLES / "parallel/multichip.py"), "--device", "cpu",
         "--init-method", f"file://{tmp_path / 'pg'}"],
        env={**os.environ, "RANK": str(rank), "WORLD_SIZE": "2", "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
        assert f"rank {rank}: sharded SMC (512, 9)" in log, log
    return "".join(logs)
