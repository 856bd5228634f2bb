"""The port's spans and counters (``utils/profiling.py``, ``utils/host.py``,
``ops/_build.load_counts``) on the CPU: ``sample_chains(...,
platform="cuda")`` on CPU tensors runs the kernel path through dispatch
with the kernels' plain versions."""

import json

import numpy as np
import pytest
import torch

from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops import _build
from eeyore_tpu_torch.samplers import HMC, sample_chains
from eeyore_tpu_torch.utils import host, profiling

XOR = (np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]]), np.array([[0.], [1.], [1.], [0.]]))
KERNEL_PATH = ("eeyore.plan", "eeyore.maker", "eeyore.seed", "eeyore.launch",
               "eeyore.relayout")


@pytest.fixture(autouse=True)
def no_records():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _jobs(count, backend="auto"):
    model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                device="cpu", hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
    kernel = HMC(model, step=0.05, num_steps=2)
    gen = torch.Generator().manual_seed(5)
    theta0s = 0.1 * torch.randn(1024, model.num_params, generator=gen)
    for _ in range(count):
        sample_chains(kernel, gen, theta0s, XOR, 3, backend=backend, platform="cuda")


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_nothing_is_recorded_without_a_profiler():
    _jobs(1)
    assert profiling.spans() == []


def test_each_job_is_a_root_with_the_kernel_path_inside(tmp_path):
    with _profile() as prof:
        _jobs(2)
    records = profiling.spans()
    roots = [i for i, r in enumerate(records) if r["name"] == profiling.JOB]
    assert len(roots) == 2 and all(records[i]["parent"] is None for i in roots)
    assert records[roots[0]]["job"] != records[roots[1]]["job"]
    for root in roots:
        job = records[root]["job"]
        inside = [r for r in records if r["job"] == job and r is not records[root]]
        assert [r["name"] for r in inside] == list(KERNEL_PATH)
        assert all(r["parent"] == root for r in inside)
        start, end = records[root]["start_ns"], records[root]["end_ns"]
        cursor = start
        for r in inside:  # in order, one after another, inside the root
            assert cursor <= r["start_ns"] <= r["end_ns"] <= end
            cursor = r["end_ns"]
        assert all(r["device_ms"] is None for r in inside)  # no card to time
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert annotated >= {profiling.JOB, *KERNEL_PATH}


def test_the_generic_path_records_the_root_alone():
    with _profile():
        _jobs(1, backend="scan")
    records = profiling.spans()
    assert [(r["name"], r["parent"]) for r in records] == [(profiling.JOB, None)]


def test_device_trace_writes_the_window_spans(tmp_path):
    _jobs(1)
    with profiling.device_trace(tmp_path):
        _jobs(1)
    (path,) = tmp_path.glob("spans_*.json")
    written = json.loads(path.read_text())
    assert [r["name"] for r in written] == [profiling.JOB, *KERNEL_PATH]
    assert [r["parent"] for r in written] == [None] + [0] * len(KERNEL_PATH)
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
    assert profiling.spans() == []  # the window's records were taken


def test_spans_hands_the_records_over_once():
    with _profile():
        _jobs(1)
    first = profiling.spans()
    assert [r["name"] for r in first] == [profiling.JOB, *KERNEL_PATH]
    assert profiling.spans() == []


def test_self_ms_takes_overlapping_children_once():
    def rec(name, start, end, parent):
        return {"name": name, "start_ns": start * 10**6, "end_ns": end * 10**6,
                "parent": parent, "job": 0, "host_syncs": 0, "device_ms": None}

    records = [rec("eeyore.plan", 0, 10, None), rec("eeyore.library", 1, 4, 0),
               rec("eeyore.codegen", 3, 6, 0), rec("eeyore.library", 8, 9, 0),
               rec("eeyore.codegen", 8.5, 12, 0), rec("x", 2, 3, 1),
               rec("eeyore.plan", 20, 25, None)]
    # children cover [1, 6] and [8, 10] of the first plan: 10 - 7; the second has none
    assert profiling.self_ms(records, "eeyore.plan") == pytest.approx(3 + 5)
    assert profiling.self_ms(records, "eeyore.library") == pytest.approx(2 + 1)
    assert profiling.self_ms(records, "missing") == 0


def test_load_library_counts_one_build_then_loads(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    built = []
    monkeypatch.setattr(_build, "_libraries", {})
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(cpp_extension, "load", lambda **kw: built.append(kw) or "lib.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("library", path))
    before = dict(_build.load_counts)
    libs = [_build.load_library("probe", "resident_hmc.cu", ("A=1",),
                                generated={"body.cuh": "// one"}) for _ in range(3)]
    assert len(built) == 1 and libs[0] is libs[1] is libs[2]
    assert _build.load_counts == {"loads": before["loads"] + 3, "builds": before["builds"] + 1}
    assert (tmp_path / built[0]["name"] / "body.cuh").read_text() == "// one"
    with _profile():
        _build.load_library("probe", "resident_hmc.cu", ("A=1",), generated={"body.cuh": "// two"})
        _build.load_library("probe", "resident_hmc.cu", ("A=1",), generated={"body.cuh": "// two"})
    assert len(built) == 2 and _build.load_counts["builds"] == before["builds"] + 2
    # each span's record keeps the counts' increase inside it
    assert [(r["name"], r["loads"], r["builds"], r["host_syncs"]) for r in profiling.spans()] \
        == [("eeyore.library", 1, 1, 0), ("eeyore.library", 1, 0, 0)]


def test_host_reads_of_cpu_tensors_are_not_syncs():
    before = host.sync_counts["syncs"]
    assert host.host_scalar(torch.tensor([7])) == 7
    np.testing.assert_array_equal(host.host_array(torch.arange(3.0)), [0.0, 1.0, 2.0])
    assert host.host_array(None) is None and host.host_scalar(2.5) == 2.5
    with _profile():
        _jobs(1)
    assert host.sync_counts["syncs"] == before
    (root,) = [r for r in profiling.spans() if r["name"] == profiling.JOB]
    assert root["host_syncs"] == 0
