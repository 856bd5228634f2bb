"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names its configuration and its traffic.
``portbench/workloads/<cell>.json`` holds what the check needs (the kernel
that must run, the sample it replays, the limits), the configuration's
``file`` its model, dataset and reference posterior (``reference``, a file
under ``portbench/``), ``portbench/traffic/<traffic>.json`` the sampling
job; a per-layer metric is read by ``portbench/metrics/<name>.py``
and a kernel's work is counted by ``portbench/work/<kernel>.py``. Adding a
cell, a configuration, a traffic mix, a metric or a kernel's count is adding
such files and entries.
"""

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return _load_json(ROOT / "BENCHMARK.json")


def _by_name(entries, name, what):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def load_module(path, name):
    """A Python file of the benchmark as a module (its file name may hold
    dots, as a metric's does)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """Everything a run of one cell reads: ``entry`` (its line of
    ``workloads``), ``spec`` (its file), ``config``, ``traffic``,
    ``end_to_end`` and ``per_layer`` (the metrics that it reports)."""

    def __init__(self, name, bench=None):
        bench = bench or benchmark()
        self.name = name
        self.entry = _by_name(bench["workloads"], name, "workload")
        self.spec = _load_json(BENCH_DIR / "workloads" / f"{name}.json")
        config_entry = _by_name(bench["configs"], self.entry["config"], "config")
        self.config = _load_json(ROOT / config_entry["file"])
        self.traffic = _load_json(BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]
        for part, named in (("config", self.config), ("traffic", self.traffic)):
            if named["name"] != self.entry[part]:
                raise ValueError(f"{name}: the {part} file is named {named['name']!r}")
        if self.spec["config"] != self.entry["config"] or \
                self.spec["traffic"] != self.entry["traffic"]:
            raise ValueError(f"{name}: the cell file and BENCHMARK.json disagree")

    def _reports(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    @property
    def kernel(self):
        return self.spec["kernel"]


def metric_reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", f"portbench_metric_{name}")


def work_counter(kernel):
    return load_module(BENCH_DIR / "work" / f"{kernel}.py", f"portbench_work_{kernel}")


def reference_of(config):
    """The reference module that the configuration's ``reference`` key names
    (a file under ``portbench/``, with ``posterior(config, x, y, dtype,
    device)``); a path that leads out of ``portbench/`` is refused."""
    path = (BENCH_DIR / config["reference"]).resolve()
    if not path.is_relative_to(BENCH_DIR) or not path.is_file():
        raise ValueError(f"{config['name']}: unknown reference {config['reference']!r}")
    module = load_module(path, "portbench_reference_" + path.stem)
    if not callable(getattr(module, "posterior", None)):
        raise ValueError(f"{config['name']}: the reference {config['reference']!r} "
                         "has no posterior(config, x, y, dtype, device)")
    return module


def resolve(path):
    """A path that a benchmark file gives relative to the repository root."""
    return ROOT / path
