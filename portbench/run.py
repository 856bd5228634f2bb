#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's model, data and sampler through ``eeyore_tpu_torch``'s
public entry points, warms up, then runs sampling jobs back to back for
``--seconds`` (a closed loop with one caller: each job is one
``sample_chains`` call ending in ``torch.cuda.synchronize()``, with a fresh
generator seeded from (seed, call index)), checks the last job's outputs
against the plain reference (``harness/check.py``) and prints one JSON line:
the end-to-end metrics with ``--trace 0``, the per-layer metrics with
``--trace 1`` (read from a ``torch.profiler`` window of a fixed number of
further jobs). The numbers compared, each beside its limit, end standard
error and the result line. It needs a CUDA card: without one, or with fewer
cards than the cell asks for, it exits with 2 and prints no result.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "eeyore_tpu")
# the seed of the set of starting states, 0.1 N(0, 1), that every run permutes
STARTS_SEED = 20260101


def _process_start():
    """When this process started, on the wall clock (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


for path in (str(BENCH_DIR), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

from harness import check, program, trace  # noqa: E402
from harness.layer_metrics import least_time  # noqa: E402
from harness.peaks import peaks_of  # noqa: E402
from harness.spec import Cell, metric_reader, work_counter  # noqa: E402
from reference.threefry import kernel_seed  # noqa: E402


def call_seed(seed, index):
    """The generator seed of job ``index`` of a run (warm-up jobs have
    negative indices)."""
    return (int(seed) * 1000003 + 7919 * (index + 3)) % (2 ** 63)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def work_counts(traffic, learnt):
    """What a chain of one job did, at the least its inputs needed:
    {"evaluations": value-and-gradient evaluations}, and for NUTS the live
    leaves' U-turn tests ("checks") and merged subtrees ("merges"), each
    counted by the check's replay of the kept transitions and of the
    burn-in."""
    iters, burnin = traffic["iterations"], traffic["burnin"]
    args = traffic["args"]
    if traffic["sampler"] == "MALA":
        return {"evaluations": 1 + iters}
    if traffic["sampler"] == "NUTS":
        kept, burn = learnt["kept_work"], learnt["burnin_work"]
        per_chain = {k: burn[k] + (iters - burnin) * kept[k] for k in kept}
        return {"evaluations": 1 + per_chain["leaves"], "checks": per_chain["checks"],
                "merges": per_chain["merges"]}
    if traffic["tuner"] is None:
        return {"evaluations": 1 + iters * int(args["num_steps"])}
    return {"evaluations": learnt["burnin_evaluations"]
            + (iters - burnin) * float(learnt["n"].double().mean())}


def run_cell(cell, seed, seconds, traced, device="cuda", overrides=None, control=False,
             started=None):
    """One run: (result dict, {number: [value, limit]}). ``device="cpu"``
    runs the kernels' plain versions (``platform="cuda"``) for the tests;
    ``overrides`` {"traffic": {...}, "check": {...}, "limits": {...}}
    resizes a cell there. ``control`` adds the control's readings (the
    reference in bfloat16 in the program's place) under "control".
    ``started``: when the process started (``setup_s`` counts from it)."""
    started = time.time() if started is None else started
    overrides = overrides or {}
    traffic = {**cell.traffic, **overrides.get("traffic", {})}
    spec = {**cell.spec["check"], **overrides.get("check", {})}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.set_num_threads(1)
    C, iters, burnin = traffic["chains"], traffic["iterations"], traffic["burnin"]
    kept = iters - burnin
    P = cell.config["num_params"]

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def generator(index):
        gen = torch.Generator(device=dev)
        gen.manual_seed(call_seed(seed, index))
        return gen

    x, y = program.dataset(cell.config, dev)
    model = program.build_model(cell.config, dev)
    sampler = program.build_sampler(traffic, model)
    # every seed starts from the same set of states, in its own order: how
    # long the kernels take depends on where the chains start
    start_gen = torch.Generator(device=dev)
    start_gen.manual_seed(STARTS_SEED)
    starts = 0.1 * torch.randn((C, P), generator=start_gen, device=dev, dtype=torch.float32)
    start_gen.manual_seed(int(seed) % (2 ** 63))
    theta0s = starts[torch.randperm(C, generator=start_gen, device=dev)]
    del starts
    call = program.job(sampler, theta0s, (x, y), traffic, None if on_card else "cuda")
    counters = program.launch_counts

    for index in (-2, -1):  # builds the kernel and the maker, then a steady call
        out = call(generator(index))
        sync()
        del out
    setup_s = time.time() - started

    walls, wrong_launches = [], 0
    out = None
    deadline = time.perf_counter() + seconds
    t0 = time.perf_counter()
    while True:
        out = None  # the previous job's outputs go before the next job
        before = counters()
        start = time.perf_counter()
        out = call(generator(len(walls)))
        sync()
        walls.append(time.perf_counter() - start)
        after = counters()
        made = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        wrong_launches += made != {cell.kernel: 1}
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    calls = len(walls)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    steps = None
    if spec["kind"] == "nuts":
        steps = program.kernel_last_info(cell.kernel)["step"].detach().clone()
    chains, burnin_groups = check.select(spec, C, seed)
    inputs = check.Inputs(out, chains, burnin_groups, C, kept, P,
                          kernel_seed(call_seed(seed, calls - 1), dev.type), theta0s, x, y, steps)
    del out
    if on_card:
        torch.cuda.empty_cache()

    parsed = None
    if traced:
        def traced_call(i):
            call(generator(calls + i))
            sync()

        parsed = trace.traced_calls(traced_call, int(traffic["trace_calls"]))

    judge = check.Judge(cell, traffic, spec, dev)
    check_start = time.perf_counter()
    numbers, learnt = judge.run(inputs, launches=wrong_launches if on_card else None)
    check_s = time.perf_counter() - check_start
    limits = {**cell.spec["limits"], **overrides.get("limits", {})}
    correct, lines = check.verdict(numbers, limits)

    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": name,
                   "count": cell.entry["chips"], "memory_peak_bytes": int(memory_peak)}
    notes = {"calls": calls, "window_s": window_s, "check_s": check_s,
             "transitions_checked": learnt["transitions"],
             "tied_share": learnt["tied_share"], "card": _power_limit() if on_card else None}
    for key in ("step_ref", "step_prog", "n_ref"):
        if key in learnt:
            notes[key] = learnt[key]
    metrics = {}
    if not traced:
        values = {"samples_per_s": calls * C * iters / window_s,
                  "call_p90_s": (statistics.quantiles(walls, n=10, method="inclusive")[-1]
                                 if calls > 1 else walls[0]),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        counts = work_counts(traffic, learnt)
        work = work_counter(cell.kernel).work(cell.config, traffic, x.cpu().numpy(), counts)
        ctx = {"cell": cell, "trace": parsed, "walls": walls, "window_s": window_s,
               "work": work, "peaks": peaks_of(name)}
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=parsed["busy_s"], window_s=parsed["window_s"])
        seconds_k, traced_launches = trace.kernel_time(parsed, cell.spec["kernel_symbol"])
        notes.update(work_per_chain=counts, flops=work["flops"], bytes=work["bytes"],
                     kernel_s_per_launch=seconds_k, kernel_launches_traced=traced_launches,
                     calls_traced=int(traffic["trace_calls"]))
        if ctx["peaks"] is not None:
            notes["roofline_side"] = least_time(ctx)[1]
    result = {"correct": bool(correct), "attempted": calls,
              "failed": wrong_launches if on_card else 0,
              "metrics": metrics, "device": device_info}
    if traced:
        result["breakdown"] = trace.breakdown(parsed)
    result["notes"] = notes
    if control:
        result["control"], control_learnt = judge.run(inputs, control=True)
        result["control_notes"] = {k: v for k, v in control_learnt.items()
                                   if k in ("step_ref", "step_prog", "tied_share")}
        if "burnin_tolerance" in spec:
            result["control_notes"].update(judge.burnin_readings(inputs))
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in lines.items()}
    return result, lines


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    started = _process_start()
    cell = Cell(args.workload)
    import eeyore_tpu_torch  # noqa: F401  (the program under test)

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), started=started)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for name, (value, limit) in lines.items():
        print(f"check {name}: {value} limit {limit}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
