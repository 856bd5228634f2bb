"""The readers of the program's own spans and counters in a traced run on
the CPU (the kernels' plain versions stand in for the card): each gives a
value or None and none raises; the host spans read a time, the host syncs
none (no card), the builds none, and the re-layout nothing (no card to time
it)."""

import run
from harness.spec import Cell

SMALL = {"traffic": {"chains": 1024, "iterations": 12, "trace_calls": 3},
         "check": {"chains": 64}}


def test_traced_cpu_run_reads_the_program_spans():
    from eeyore_tpu_torch.utils import profiling

    profiling.clear_spans()
    result, _ = run.run_cell(Cell("xor_hmc"), 2147483659, 0.0, True, device="cpu",
                             overrides=SMALL)
    metrics = result["metrics"]
    assert metrics["plan_ms"]["value"] > 0 and metrics["maker_ms"]["value"] > 0
    assert metrics["host_syncs"]["value"] == 0
    assert metrics["library_builds"]["value"] == 0  # the warm-up built every library
    assert metrics["library_ms"]["value"] == 0  # untuned dense HMC loads no library a job
    assert "relayout_ms" not in metrics
