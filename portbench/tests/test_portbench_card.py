"""Each cell at its own size on the card: a short run prints a result line
with every key the contract asks for, reads correct, and a traced run
reports every per-layer metric the cell lists."""

import json
import subprocess
import sys

import pytest

from harness.spec import ROOT, Cell, benchmark

CELLS = [w["name"] for w in benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, traced):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", "2147483777", "--seconds", "2", "--trace", str(traced)],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    c = Cell(cell)
    wanted = [m["name"] for m in (c.per_layer if traced else c.end_to_end)]
    assert set(result["metrics"]) == set(wanted)
    if traced:
        assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
        for name, metric in result["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < metric["value"] <= 100
