"""Chip check of the PyTorch/CUDA port (``eeyore_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card (Hopper: the
kernels are built for sm_90a). Phases, one JSON line each:

1. build: builds the fused log-posterior kernel ``fused_mlp_vg`` from
   ``eeyore_tpu_torch/ops/csrc/`` for the three architectures below, and
   reports each build's registers and local-memory (spill) bytes per thread.
2. kernel vs plain: calls the kernel's wrapper on the card at C = 32768 and
   131072 seeded random chains (the main paths' chain counts) and holds it
   against the plain PyTorch ``make_vg`` on the same inputs (rtol 2e-5, atol
   1e-4; 3e-4 on the 150-row iris case, as tests/test_ops.py::compare), for
   iris MLP(4,3,3) CE, XOR MLP(2,2,1) BCE and MLP(3,4,2,1) without biases on
   layers 0 and 2, a (0.5, 2.0) prior and temperature 0.3; and times both.
3. main path, iris: tuned ``FusedHMC`` on the MLP(4,3,3) iris posterior
   (HMCDATuner(l=0.15, e0=0.02), max_num_steps=64), 32768 chains, 1500
   iterations, 500 burn-in. Checks finite samples, post-burn-in acceptance
   in 0.65 +- 0.15, and pooled posterior means within 5 pooled Monte-Carlo
   standard errors of an independent ``use_fused_kernel=False`` run.
4. main path, XOR: ``FusedHMC`` MLP(2,2,1), step 0.05, 10 leapfrog steps,
   131072 chains, 256 iterations. Checks finite samples and acceptance in
   (0.2, 1].
5. profile: device time by kernel over 200 post-burn-in iris iterations,
   and its share of the host-clock time of 200 unprofiled iterations.
6. kernels: each kernel's launches on the main path, its error against the
   plain version, its time, the plain version's time and its bound.

Then the card's name and power limit, and last ``{"ok": true, "device": ...}``.
Any failed check raises, and the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available.
"""

import argparse
import concurrent.futures
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, at the 700 W limit):
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Special-function unit (exp2, log2, reciprocal): 16 results per clock per SM
# on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), at the H100 SXM boost clock of 1.98 GHz.
SFU_PER_CLOCK_PER_SM = 16
BOOST_CLOCK_HZ = 1.98e9

KERNEL_SOURCE = "eeyore_tpu_torch/ops/csrc/fused_mlp_vg.cu"
KERNEL_REPLACES = "eeyore_tpu/ops/fused_mlp.py:63"


def check(ok, message):
    if not ok:
        raise RuntimeError(message)


def emit(record):
    print(json.dumps(record), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def profiled(fn):
    """Run ``fn()`` under torch.profiler and return (its result, {kernel name:
    device ms}), the summed durations of the device work it launched."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        result = fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[event.name] = by_kernel.get(event.name, 0.0) + event.time_range.elapsed_us() / 1e3
    return result, by_kernel


def device_ms(fn, reps):
    """Device time per call of ``fn()``: the durations of the kernels it
    launches, traced over ``reps`` calls after two warm-up calls. Unlike CUDA
    events around a loop of calls, this leaves out the gaps in which the
    device waits for the host to launch the next call."""
    fn()
    fn()
    _, by_kernel = profiled(lambda: [fn() for _ in range(reps)])
    return sum(by_kernel.values()) / reps


def vg_work(dims, bias, ce, n_rows, C):
    """(bytes, f32 operations, special-function operations) that the fused
    value-and-gradient needs for C chains over n_rows data rows, counted
    from the code. Bytes: theta read once, value and gradient written once,
    the data and prior read once. Operations: a multiply-add is 2; an add,
    subtract, multiply or max is 1; exp, log, log1p and the sigmoid's
    reciprocal are one special-function operation each."""
    L = len(dims) - 1
    P = sum(dims[l] * dims[l + 1] + (dims[l + 1] if bias[l] else 0) for l in range(L))
    k = dims[-1]
    layer_macs = [dims[l] * dims[l + 1] for l in range(L)]
    macs = 2 * sum(layer_macs) + sum(layer_macs[1:])  # forward, weight grads, deltas
    bias_units = sum(dims[l + 1] for l in range(L) if bias[l])
    sigmoid_units = sum(dims[1:-1]) + (0 if ce else k)
    ops = 2 * macs + 2 * bias_units               # bias add and bias gradient
    ops += 2 * sigmoid_units                      # 1 + exp(-z), negation
    ops += 3 * sum(dims[1:-1])                    # delta * a * (1 - a)
    sfu = 2 * sigmoid_units                       # exp and reciprocal
    if ce:
        ops += (k - 1) + k + (k - 1) + 1 + 2 * k + 2 + 3 * k  # max, shifts, sum, lse, picked, ll, deltas
        sfu += k + 2                              # k exps shared by lse and softmax, log, reciprocal
    else:
        ops += k * (3 + 4 + 2)                    # softplus, ll, delta
        sfu += 2 * k                              # exp and log1p in softplus
    prior_ops = 6 * P + 2                         # per chain: diff, square, scale, sum, grad
    n_bytes = 4 * (2 * P * C + C + n_rows * (dims[0] + k + 1) + 2 * P)
    return n_bytes, C * (n_rows * ops + prior_ops), C * n_rows * sfu


def bound_ms(work, sm_count):
    n_bytes, ops, sfu = work
    times = {"bytes": n_bytes / HBM_BYTES_PER_S, "ops": ops / F32_OPS_PER_S,
             "sfu": sfu / (sm_count * SFU_PER_CLOCK_PER_SM * BOOST_CLOCK_HZ)}
    worst = max(times, key=times.get)
    return 1e3 * times[worst], "bytes" if worst == "bytes" else "operations"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result", file=sys.stderr)
        return 1

    from eeyore_tpu_torch.datasets import XYDataset
    from eeyore_tpu_torch.models import MLP, IIDNormalPrior, loss_functions, mlp
    from eeyore_tpu_torch.ops import fused_mlp
    from eeyore_tpu_torch.ops.fused_hmc import FusedHMC
    from eeyore_tpu_torch.ops.mlp_math import extract_arch, make_vg, prepare_data
    from eeyore_tpu_torch.tuners import HMCDATuner

    device = torch.device("cuda")
    card = card_line()
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(args.seed)

    def make_model(dims, loss, activations="default", bias=None):
        return MLP(loss=loss_functions[loss], dtype=torch.float32, device=device,
                   hparams=mlp.Hyperparameters(dims=dims, bias=bias, activations=activations))

    iris = XYDataset.from_eeyore("iris", yonehot=True)
    xor = XYDataset.from_eeyore("xor")
    iris_model = make_model([4, 3, 3], "multiclass_classification", [mlp.sigmoid, None])
    xor_model = make_model([2, 2, 1], "binary_classification")
    deep_model = make_model([3, 4, 2, 1], "binary_classification", bias=[False, True, False])
    deep_model.prior = IIDNormalPrior(np.full(deep_model.num_params, 0.5),
                                      np.full(deep_model.num_params, 2.0),
                                      dtype=torch.float32, device=device)
    deep_model.temperature = 0.3
    deep_x = rng.normal(size=(10, 3))
    deep_y = rng.integers(0, 2, size=(10, 1)).astype(np.float64)
    cases = [("iris_mlp433_ce", iris_model, iris.x, iris.y, 3e-4),
             ("xor_mlp221_bce", xor_model, xor.x, xor.y, 1e-4),
             ("mlp3421_nobias_prior_temp", deep_model, deep_x, deep_y, 1e-4)]

    # 1. build
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        futures = [pool.submit(fused_mlp.load_kernel, model) for _, model, _, _, _ in cases]
        libs = [f.result() for f in futures]
    emit({"phase": "build", "kernel": fused_mlp.KERNEL, "source": KERNEL_SOURCE,
          "seconds": time.perf_counter() - start,
          "resources": {name: fused_mlp.kernel_resources(lib)
                        for (name, *_), lib in zip(cases, libs)}, "card": card})

    # 2. kernel vs plain, on the same inputs on the card, at the main paths'
    #    chain counts (iris runs 32768 chains, XOR 131072)
    max_abs_err = 0.0
    timings = {}
    for (name, model, x, y, atol), lib in zip(cases, libs):
        arrays = prepare_data(model, x, y)
        tensors = [torch.as_tensor(a, device=device) for a in arrays[:5]]
        prior_const, temperature = arrays[5], arrays[6]
        plain = make_vg(model, *arrays)
        dims, bias, loss_kind, _ = extract_arch(model)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        for C in (32768, 131072):
            theta = torch.randn((model.num_params, C), generator=gen, device=device)
            val, grad = fused_mlp.fused_mlp_vg(lib, theta, *tensors, prior_const, temperature)
            pval, pgrad = plain(theta, *tensors)
            torch.cuda.synchronize()
            err = max((val - pval).abs().max().item(), (grad - pgrad).abs().max().item())
            for got, want in ((val, pval), (grad, pgrad)):
                bad = ((got - want).abs() > atol + 2e-5 * want.abs()) | ~torch.isfinite(got)
                check(not bool(bad.any()), f"{name}, C={C}: kernel disagrees with make_vg at "
                      f"{int(bad.sum())} entries, max abs err {err}")
            max_abs_err = max(max_abs_err, err)
            ms = device_ms(lambda: fused_mlp.fused_mlp_vg(lib, theta, *tensors, prior_const,
                                                          temperature), 50)
            plain_ms = device_ms(lambda: plain(theta, *tensors), 5)
            b_ms, b_by = bound_ms(vg_work(dims, bias, loss_kind == "ce", len(x), C), sm_count)
            timings[(name, C)] = (ms, plain_ms, b_ms, b_by)
            emit({"phase": "kernel_vs_plain", "case": name, "chains": C, "max_abs_err": err,
                  "rtol": 2e-5, "atol": atol, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "card": card})

    # 3. main path, iris (BASELINE.md config 3)
    C, iters, burnin = 32768, 1500, 500
    theta0s = torch.as_tensor(0.1 * rng.normal(size=(C, iris_model.num_params)),
                              dtype=torch.float32, device=device)
    tuner = HMCDATuner(l=0.15, e0=0.02)
    summaries = {}
    launches = {}
    for fused in (True, False):
        hmc = FusedHMC(iris_model, iris.x, iris.y, step=tuner.e0, tuner=tuner,
                       max_num_steps=64, device=device, use_fused_kernel=fused)
        seed = args.seed if fused else args.seed + 1  # independent draws for the comparison
        fused_mlp.launch_counts[fused_mlp.KERNEL] = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, rec = hmc.run(seed, theta0s, iters, burnin, record_keys=("sample", "accepted"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        count = fused_mlp.launch_counts[fused_mlp.KERNEL]
        if fused:
            launches["iris"] = count
            iris_hmc, iris_state = hmc, state
        check(count == 0 or fused, "the unfused run launched the fused kernel")
        check(bool(torch.isfinite(rec["sample"]).all()), "iris: non-finite samples")
        acc = rec["accepted"].float().mean().item()
        chain_means = rec["sample"].mean(dim=0, dtype=torch.float64)  # [C, P]
        summaries[fused] = (chain_means.mean(0), chain_means.std(0) / math.sqrt(C))
        emit({"phase": "main_iris", "fused_kernel": fused, "chains": C, "iterations": iters,
              "burnin": burnin, "seconds": wall, "samples_per_s": C * iters / wall,
              "acceptance_post_burnin": acc, "final_step": state.step.item(),
              "final_num_steps": int(state.num_steps), "kernel_launches": count,
              "launches_per_iteration": count / iters,
              "seconds_per_launch": wall / count if count else None, "card": card})
        del rec, state
        torch.cuda.empty_cache()
        check(abs(acc - 0.65) <= 0.15, f"iris: acceptance {acc} outside 0.65 +- 0.15")
    check(launches["iris"] > 0, "iris main path never launched the fused kernel")
    (m1, s1), (m2, s2) = summaries[True], summaries[False]
    z = ((m1 - m2).abs() / torch.sqrt(s1 ** 2 + s2 ** 2)).max().item()
    emit({"phase": "main_iris_vs_unfused", "max_abs_z_pooled_mean": z, "limit": 5.0,
          "card": card})
    check(z <= 5.0, f"iris: pooled means differ by {z} pooled standard errors")

    # 4. main path, XOR (the bench.py problem)
    C, iters = 131072, 256
    hmc = FusedHMC(xor_model, xor.x, xor.y, step=0.05, num_steps=10, device=device)
    theta0s = torch.as_tensor(0.1 * rng.normal(size=(C, xor_model.num_params)),
                              dtype=torch.float32, device=device)
    fused_mlp.launch_counts[fused_mlp.KERNEL] = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, rec = hmc.run(args.seed, theta0s, iters, 0, record_keys=("sample", "accepted"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches["xor"] = fused_mlp.launch_counts[fused_mlp.KERNEL]
    check(launches["xor"] > 0, "XOR main path never launched the fused kernel")
    check(bool(torch.isfinite(rec["sample"]).all()), "XOR: non-finite samples")
    acc = rec["accepted"].float().mean().item()
    emit({"phase": "main_xor", "chains": C, "iterations": iters, "seconds": wall,
          "samples_per_s": C * iters / wall, "acceptance": acc,
          "kernel_launches": launches["xor"], "seconds_per_launch": wall / launches["xor"],
          "card": card})
    check(0.2 < acc <= 1.0, f"XOR: acceptance {acc} outside (0.2, 1]")
    del rec, state

    # 5. where the time goes on the iris main path: device time by kernel over
    #    post-burn-in iterations (torch.profiler), against the host clock of the
    #    same number of iterations run without the profiler
    n_prof = 200
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def iris_steps(state, first):
        for i in range(first, first + n_prof):
            state, _ = iris_hmc.step_fn(state, i, burnin, generator=gen)
        return state

    iris_state = iris_steps(iris_state, iters)
    torch.cuda.synchronize()
    start = time.perf_counter()
    iris_state = iris_steps(iris_state, iters + n_prof)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    iris_state, by_kernel = profiled(lambda: iris_steps(iris_state, iters + 2 * n_prof))
    busy = sum(by_kernel.values()) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    emit({"phase": "profile_iris", "iterations": n_prof, "chains": iris_state.thetas.shape[0],
          "num_steps": int(iris_state.num_steps), "seconds": wall,
          "device_busy_seconds": busy, "device_busy_share": busy / wall,
          "device_ms_by_kernel": {name[:60]: ms for name, ms in top}, "card": card})
    del iris_state

    # 6. kernels, timed at the iris main path's shape
    ms, plain_ms, b_ms, b_by = timings[("iris_mlp433_ce", 32768)]
    emit({"kernels": [{
        "name": fused_mlp.KERNEL, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": sum(launches.values()),
        "launches_by_path": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "timed_at": "iris MLP(4,3,3), 32768 chains"}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
