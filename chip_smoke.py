"""Chip check of the PyTorch/CUDA port (``eeyore_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card (Hopper: the
kernels are built for sm_90a). Phases, one JSON line each:

1. build: builds the fused log-posterior kernel ``fused_mlp_vg`` for the
   three architectures below and the whole-loop ``resident_hmc`` kernel for
   iris MLP(4,3,3) CE and XOR MLP(2,2,1) BCE, all at once from
   ``eeyore_tpu_torch/ops/csrc/``, and reports each build's registers and
   local-memory (spill) bytes per thread.
2. kernel vs plain: calls ``fused_mlp_vg``'s wrapper on the card at C =
   32768 and 131072 seeded random chains (the main paths' chain counts) and
   holds it against the plain PyTorch ``make_vg`` on the same inputs (rtol
   2e-5, atol 1e-4; 3e-4 on the 150-row iris case, as tests/test_ops.py::
   compare), for iris MLP(4,3,3) CE, XOR MLP(2,2,1) BCE and MLP(3,4,2,1)
   without biases on layers 0 and 2, a (0.5, 2.0) prior and temperature
   0.3; and times both.
3. resident vs plain: ``resident_hmc`` against its plain version (same
   seed, same inputs, on the card) on untuned iris (32768 chains, step 0.02,
   8 leapfrog steps, 20 iterations, record_extras), untuned XOR (131072
   chains, step 0.05, 10 steps, 20 iterations) and tuned iris (the dispatch
   plan of BASELINE.md config 3: step 0.1, 10 steps, HMCDATuner(l=0.15,
   e0=0.02), chain_block 256) with 5 burn-in and 5 kept iterations and with
   20 and 20. A chain agrees when all its outputs are within atol 1e-3 +
   rtol 1e-3 of the plain version's; at least 99% of chains must agree (an
   accept decision at u ~ rate may flip on f32 rounding and part a chain's
   path); the 20-iteration burn-in, where early long steps make the
   leapfrog chaotic, is held statistically instead (pooled means within 5
   pooled standard errors, acceptance within 0.01).
4. main path, iris, FusedHMC: tuned ``FusedHMC`` on config 3 (32768 chains,
   1500 iterations, 500 burn-in). Checks finite samples, post-burn-in
   acceptance in 0.65 +- 0.15, and pooled posterior means within 5 pooled
   Monte-Carlo standard errors of an independent ``use_fused_kernel=False``
   run.
5. main path, XOR, FusedHMC: MLP(2,2,1), step 0.05, 10 leapfrog steps,
   131072 chains, 256 iterations. Checks finite samples and acceptance in
   (0.2, 1].
6. profile, FusedHMC: device time by kernel over 200 post-burn-in iris
   iterations, and its share of the host-clock time of 200 unprofiled ones.
7. main path, iris, sample_chains: config 3 through ``sample_chains(...,
   backend="auto")``, which dispatches to ``resident_hmc``. Checks one
   launch, finite samples, post-burn-in acceptance in 0.65 +- 0.15, pooled
   means within 5 pooled standard errors of phase 4's fused run, and finite
   ``ChainLists.multi_rhat`` / ``multi_ess`` on the first 64 chains.
8. main path, XOR, sample_chains: the bench.py problem (HMC step 0.05, 10
   steps, 131072 chains x 256) through ``backend="auto"``; one launch,
   acceptance in (0.2, 1].
9. generic vs kernel: config 3 through ``sample_chains(backend="scan")``
   (the batched-autograd generic path) at 4096 chains; pooled means within
   5 pooled standard errors of phase 7's kernel run.
10. profile, sample_chains: device time by kernel of one iris call of phase
    7, against its host-clock time.
11. kernels: each kernel's launches on the main paths, its error against its
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

FUSED_SOURCE = "eeyore_tpu_torch/ops/csrc/fused_mlp_vg.cu"
FUSED_REPLACES = "eeyore_tpu/ops/fused_mlp.py:63"
RESIDENT_SOURCE = "eeyore_tpu_torch/ops/csrc/resident_hmc.cu"
RESIDENT_REPLACES = "eeyore_tpu/ops/resident_hmc.py:256"
# resident vs plain: a chain agrees when every value it recorded is within
# RESIDENT_ATOL + RESIDENT_RTOL * |plain value|; at least RESIDENT_MIN_AGREEING
# of the chains must agree
RESIDENT_ATOL = 1e-3
RESIDENT_RTOL = 1e-3
RESIDENT_MIN_AGREEING = 0.99


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


def device_ms(fn, reps, warmup=2):
    """Device time per call of ``fn()``: the durations of the kernels it
    launches, traced over ``reps`` calls after ``warmup`` calls. Unlike CUDA
    events around a loop of calls, this leaves out the gaps in which the
    device waits for the host to launch the next call."""
    for _ in range(warmup):
        fn()
    _, by_kernel = profiled(lambda: [fn() for _ in range(reps)])
    return sum(by_kernel.values()) / reps


def event_ms(fn, reps, warmup=1):
    """Time per call of ``fn()`` by CUDA events around ``reps`` calls after
    ``warmup`` calls: for a call that is one long kernel launch, its
    duration (the launch itself costs microseconds)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


# Per Threefry-2x32 call: 20 rounds of add, rotate and xor, and 5 key
# injections of 3 adds; counted as operations at the f32 rate, which no
# integer rate of the card exceeds.
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2
# Per Box-Muller pair: two uniforms (shift, or, subtract, subtract), the
# sincos polynomials and quadrant selection (about 40), log's and sqrt's
# scaling (3) and two products; log and sqrt on the special-function unit.
BOX_MULLER_OPS, BOX_MULLER_SFU = 2 * 4 + 40 + 3 + 2, 2


def resident_work(dims, bias, ce, n_rows, C, evaluations, num_iters, kept, extras):
    """(bytes, operations, special-function operations) that ``resident_hmc``
    needs: ``evaluations`` single-chain value-and-gradient evaluations (the
    initial one and one per leapfrog step, as this run's trajectories
    needed), per leapfrog step the position and momentum updates (4P), per
    iteration ceil(P/2) + 1 Threefry calls, ceil(P/2) Box-Muller pairs, the
    energies (4P + 4) and the accept (exp: 1 special-function operation);
    bytes: theta0 read, the data once, the samples (kept x (P or P+2) x C),
    the final theta and the accept counts written once."""
    P = sum(dims[l] * dims[l + 1] + (dims[l + 1] if bias[l] else 0)
            for l in range(len(dims) - 1))
    _, vg_ops, vg_sfu = vg_work(dims, bias, ce, n_rows, 1)
    pairs = (P + 1) // 2
    per_iter_ops = (pairs + 1) * THREEFRY_OPS + pairs * BOX_MULLER_OPS + 4 * P + 4
    ops = evaluations * (vg_ops + 4 * P) + C * num_iters * per_iter_ops
    sfu = evaluations * vg_sfu + C * num_iters * (pairs * BOX_MULLER_SFU + 1)
    rows = P + 2 if extras else P
    n_bytes = 4 * (P * C + n_rows * (dims[0] + dims[-1] + 1) + 2 * P
                   + kept * rows * C + P * C + C)
    return n_bytes, ops, sfu


def bound_ms(work, sm_count):
    n_bytes, ops, sfu = work
    times = {"bytes": n_bytes / HBM_BYTES_PER_S, "ops": ops / F32_OPS_PER_S,
             "sfu": sfu / (sm_count * SFU_PER_CLOCK_PER_SM * BOOST_CLOCK_HZ)}
    worst = max(times, key=times.get)
    return 1e3 * times[worst], "bytes" if worst == "bytes" else "operations"


def pooled_summary(samples):
    """(pooled mean [P], its standard error [P]) of samples [C, kept, P] from
    independent chains: the spread of the chain means over sqrt(C)."""
    chain_means = samples.mean(dim=1, dtype=torch.float64)
    return chain_means.mean(0), chain_means.std(0) / math.sqrt(samples.shape[0])


def max_z(a, b):
    (m1, s1), (m2, s2) = a, b
    return ((m1 - m2).abs() / torch.sqrt(s1 ** 2 + s2 ** 2)).max().item()


def chain_agreement(got, want, chain_dim):
    """(mask [C] of the chains whose every value agrees, max abs error over
    them) of two outputs whose dimension ``chain_dim`` is the chain."""
    C = got.shape[chain_dim]
    got = got.movedim(chain_dim, 0).reshape(C, -1).double()
    want = want.movedim(chain_dim, 0).reshape(C, -1).double()
    diff = (got - want).abs()
    bad = (diff > RESIDENT_ATOL + RESIDENT_RTOL * want.abs()) | ~torch.isfinite(got)
    ok = ~bad.any(dim=1)
    err = diff[ok].max().item() if bool(ok.any()) else float("inf")
    return ok, err


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result", file=sys.stderr)
        return 1

    from eeyore_tpu_torch.chains import ChainLists
    from eeyore_tpu_torch.datasets import XYDataset
    from eeyore_tpu_torch.models import MLP, IIDNormalPrior, loss_functions, mlp
    from eeyore_tpu_torch.ops import fused_mlp, resident_hmc
    from eeyore_tpu_torch.ops.fused_hmc import FusedHMC
    from eeyore_tpu_torch.ops.mlp_math import extract_arch, make_vg, prepare_data
    from eeyore_tpu_torch.samplers import HMC, sample_chains
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
    resident_cases = [("iris_mlp433_ce", iris_model), ("xor_mlp221_bce", xor_model)]

    # 1. build, every library at once
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(cases) + len(resident_cases)) as pool:
        futures = [pool.submit(fused_mlp.load_kernel, model) for _, model, _, _, _ in cases]
        resident_futures = [pool.submit(resident_hmc.load_kernel, model)
                            for _, model in resident_cases]
        libs = [f.result() for f in futures]
        resident_libs = [f.result() for f in resident_futures]
    emit({"phase": "build", "kernels": [fused_mlp.KERNEL, resident_hmc.KERNEL],
          "sources": [FUSED_SOURCE, RESIDENT_SOURCE], "seconds": time.perf_counter() - start,
          "resources": {fused_mlp.KERNEL: {name: fused_mlp.kernel_resources(lib)
                                           for (name, *_), lib in zip(cases, libs)},
                        resident_hmc.KERNEL: {name: resident_hmc.kernel_resources(lib)
                                              for (name, _), lib in zip(resident_cases,
                                                                        resident_libs)}},
          "card": card})

    # 2. fused kernel vs plain, on the same inputs on the card, at the main
    #    paths' chain counts (iris runs 32768 chains, XOR 131072)
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

    # 3. resident_hmc vs its plain version, same seed and inputs, on the card.
    #    A tuned run's leapfrog is chaotic while early burn-in tries long
    #    steps: there, one-ulp changes of theta0 part many of the plain
    #    version's own chains within 20 burn-in iterations (the share that
    #    still agrees is reported). So the 5-iteration burn-in run, which takes
    #    the tuner through its hand-off, is held to RESIDENT_MIN_AGREEING, and
    #    the 20-iteration one statistically: pooled means within 5 pooled
    #    standard errors, acceptance within 0.01.
    iris_tuner = HMCDATuner(l=0.15, e0=0.02)
    tuned_kw = dict(step=0.1, num_steps=10, tuner=iris_tuner, max_num_steps=64)
    resident_runs = [
        ("iris_untuned_extras", iris_model, iris, 32768,
         dict(step=0.02, num_steps=8, num_iters=20, record_extras=True)),
        ("xor_untuned", xor_model, xor, 131072, dict(step=0.05, num_steps=10, num_iters=20)),
        ("iris_tuned_burnin_5", iris_model, iris, 32768,
         dict(num_iters=10, num_burnin_iters=5, **tuned_kw)),
        ("iris_tuned_burnin_20", iris_model, iris, 32768,
         dict(num_iters=40, num_burnin_iters=20, **tuned_kw)),
    ]
    resident_err = 0.0
    resident_timings = {}

    def agreement(a, b):
        """(mask [C] of the chains that agree in every output, max abs error
        over them); outputs are samples, final, accept counts (, values,
        flags), whose chain dimensions are 1, 0, 0 (, 1, 1)."""
        agree, err = None, 0.0
        for got, want, chain_dim in zip(a, b, (1, 0, 0, 1, 1)):
            ok, e = chain_agreement(got, want, chain_dim)
            agree = ok if agree is None else agree & ok
            err = max(err, e)
        return agree, err

    for name, model, data, C, kw in resident_runs:
        fn = resident_hmc.make_resident_hmc(model, data.x, data.y, chain_block=256,
                                            device=device, **kw)
        theta0s = torch.as_tensor(0.1 * rng.normal(size=(C, model.num_params)),
                                  dtype=torch.float32, device=device)
        out = fn(args.seed, theta0s)
        start = time.perf_counter()
        plain_out, plain_info = fn.plain(args.seed, theta0s)
        evaluations = plain_info["evaluations"]
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        agree, err = agreement(out, plain_out)
        share = agree.float().mean().item()
        kept = kw["num_iters"] - kw.get("num_burnin_iters", 0)
        chaotic = name == "iris_tuned_burnin_20"
        limit = None if chaotic else RESIDENT_MIN_AGREEING
        z = max_z(pooled_summary(out[0].transpose(0, 1)),
                  pooled_summary(plain_out[0].transpose(0, 1)))
        acc_diff = abs(out[2].mean().item() - plain_out[2].mean().item()) / kept
        plain_self_share = None
        if chaotic:
            moved = torch.nextafter(theta0s, torch.full_like(theta0s, math.inf))
            plain_self_share = agreement(fn.plain(args.seed, moved)[0],
                                         plain_out)[0].float().mean().item()
        ms = event_ms(lambda: fn(args.seed, theta0s), 1, warmup=0)
        dims, bias, loss_kind, _ = extract_arch(model)
        work = resident_work(dims, bias, loss_kind == "ce", len(data.x), C, evaluations,
                             kw["num_iters"], kept, kw.get("record_extras", False))
        b_ms, b_by = bound_ms(work, sm_count)
        resident_timings[name] = (ms, plain_ms, b_ms, b_by)
        emit({"phase": "resident_vs_plain", "case": name, "chains": C,
              "iterations": kw["num_iters"], "burnin": kw.get("num_burnin_iters", 0),
              "evaluations_per_chain": evaluations / C, "share_agreeing": share,
              "limit": limit, "atol": RESIDENT_ATOL, "rtol": RESIDENT_RTOL,
              "max_abs_err_agreeing": err, "plain_self_share_one_ulp": plain_self_share,
              "max_abs_z_pooled_mean": z,
              "acceptance_difference": acc_diff, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by, "card": card})
        if chaotic:
            check(z <= 5.0 and acc_diff <= 0.01, f"{name}: pooled means {z} SEs apart, "
                  f"acceptance {acc_diff} apart")
        else:
            check(share >= limit, f"{name}: only {share:.4f} of chains agree with the plain "
                  f"version (limit {limit})")
            resident_err = max(resident_err, err)
        del out, plain_out
        torch.cuda.empty_cache()

    # 4. main path, iris, FusedHMC (BASELINE.md config 3)
    C, iters, burnin = 32768, 1500, 500
    iris_theta0s = torch.as_tensor(0.1 * rng.normal(size=(C, iris_model.num_params)),
                                   dtype=torch.float32, device=device)
    summaries = {}
    launches = {}
    for fused in (True, False):
        hmc = FusedHMC(iris_model, iris.x, iris.y, step=iris_tuner.e0, tuner=iris_tuner,
                       max_num_steps=64, device=device, use_fused_kernel=fused)
        seed = args.seed if fused else args.seed + 1  # independent draws for the comparison
        fused_mlp.launch_counts[fused_mlp.KERNEL] = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, rec = hmc.run(seed, iris_theta0s, iters, burnin,
                             record_keys=("sample", "accepted"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        count = fused_mlp.launch_counts[fused_mlp.KERNEL]
        if fused:
            launches["iris"] = count
            iris_hmc, iris_state = hmc, state
        check(count == 0 or fused, "the unfused run launched the fused kernel")
        check(bool(torch.isfinite(rec["sample"]).all()), "iris: non-finite samples")
        acc = rec["accepted"].float().mean().item()
        summaries[fused] = pooled_summary(rec["sample"].transpose(0, 1))
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
    z = max_z(summaries[True], summaries[False])
    emit({"phase": "main_iris_vs_unfused", "max_abs_z_pooled_mean": z, "limit": 5.0,
          "card": card})
    check(z <= 5.0, f"iris: pooled means differ by {z} pooled standard errors")

    # 5. main path, XOR, FusedHMC (the bench.py problem)
    C, xor_iters = 131072, 256
    hmc = FusedHMC(xor_model, xor.x, xor.y, step=0.05, num_steps=10, device=device)
    xor_theta0s = torch.as_tensor(0.1 * rng.normal(size=(C, xor_model.num_params)),
                                  dtype=torch.float32, device=device)
    fused_mlp.launch_counts[fused_mlp.KERNEL] = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, rec = hmc.run(args.seed, xor_theta0s, xor_iters, 0,
                         record_keys=("sample", "accepted"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches["xor"] = fused_mlp.launch_counts[fused_mlp.KERNEL]
    check(launches["xor"] > 0, "XOR main path never launched the fused kernel")
    check(bool(torch.isfinite(rec["sample"]).all()), "XOR: non-finite samples")
    acc = rec["accepted"].float().mean().item()
    emit({"phase": "main_xor", "chains": C, "iterations": xor_iters, "seconds": wall,
          "samples_per_s": C * xor_iters / wall, "acceptance": acc,
          "kernel_launches": launches["xor"], "seconds_per_launch": wall / launches["xor"],
          "card": card})
    check(0.2 < acc <= 1.0, f"XOR: acceptance {acc} outside (0.2, 1]")
    del rec, state

    # 6. where the time goes on the FusedHMC iris path: device time by kernel
    #    over post-burn-in iterations (torch.profiler), against the host
    #    clock of the same number of iterations run without the profiler
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

    # 7. main path, iris, through sample_chains(backend="auto")
    iris_data = (iris.x, iris.y)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)

    def iris_chains(seed_gen):
        kernel = HMC(iris_model, tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64)
        return sample_chains(kernel, seed_gen, iris_theta0s, iris_data, iters, burnin,
                             backend="auto")

    resident_launches = {}
    resident_hmc.launch_counts[resident_hmc.KERNEL] = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    chains = iris_chains(gen)
    torch.cuda.synchronize()
    iris_wall = time.perf_counter() - start
    resident_launches["iris"] = resident_hmc.launch_counts[resident_hmc.KERNEL]
    check(resident_launches["iris"] == 1,
          f"iris sample_chains made {resident_launches['iris']} resident_hmc launches, not 1")
    samples = chains.get_samples()
    check(samples.shape == (iris_theta0s.shape[0], iters - burnin, iris_model.num_params),
          f"iris: samples of shape {tuple(samples.shape)}")
    check(bool(torch.isfinite(samples).all()), "iris sample_chains: non-finite samples")
    acc = chains.tensor("accepted").float().mean().item()
    kernel_summary = pooled_summary(samples)
    z = max_z(kernel_summary, summaries[True])
    head = ChainLists.from_arrays({k: chains.tensor(k)[:64].cpu() for k in chains.keys()})
    rhat = head.multi_rhat()[0]
    ess = head.multi_ess()
    emit({"phase": "main_sample_chains_iris", "chains": samples.shape[0], "iterations": iters,
          "burnin": burnin, "seconds": iris_wall,
          "samples_per_s": samples.shape[0] * iters / iris_wall,
          "acceptance_post_burnin": acc, "kernel_launches": resident_launches["iris"],
          "max_abs_z_pooled_mean_vs_fused": z, "limit": 5.0,
          "multi_rhat_first_64": rhat, "multi_ess_mean_first_64": float(np.mean(ess)),
          "card": card})
    check(abs(acc - 0.65) <= 0.15, f"iris sample_chains: acceptance {acc} outside 0.65 +- 0.15")
    check(z <= 5.0, f"iris sample_chains: pooled means differ from FusedHMC's by {z} SEs")
    check(math.isfinite(rhat) and all(math.isfinite(e) for e in ess),
          f"iris: multi_rhat {rhat} or multi_ess {ess[:4]}... not finite")
    del chains, samples, head
    torch.cuda.empty_cache()

    # 8. main path, XOR (the bench.py problem), through sample_chains
    resident_hmc.launch_counts[resident_hmc.KERNEL] = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    chains = sample_chains(HMC(xor_model, step=0.05, num_steps=10), gen, xor_theta0s,
                           (xor.x, xor.y), xor_iters, backend="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    resident_launches["xor"] = resident_hmc.launch_counts[resident_hmc.KERNEL]
    check(resident_launches["xor"] == 1,
          f"XOR sample_chains made {resident_launches['xor']} resident_hmc launches, not 1")
    check(bool(torch.isfinite(chains.get_samples()).all()), "XOR sample_chains: non-finite")
    acc = chains.tensor("accepted").float().mean().item()
    emit({"phase": "main_sample_chains_xor", "chains": xor_theta0s.shape[0],
          "iterations": xor_iters, "seconds": wall,
          "samples_per_s": xor_theta0s.shape[0] * xor_iters / wall, "acceptance": acc,
          "kernel_launches": resident_launches["xor"], "card": card})
    check(0.2 < acc <= 1.0, f"XOR sample_chains: acceptance {acc} outside (0.2, 1]")
    del chains
    torch.cuda.empty_cache()

    # 9. the generic path (batched autograd) on the same problem, fewer chains
    C_generic = 4096
    resident_hmc.launch_counts[resident_hmc.KERNEL] = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    chains = sample_chains(HMC(iris_model, tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64),
                           gen, iris_theta0s[:C_generic], iris_data, iters, burnin,
                           record_keys=("sample", "accepted"), backend="scan")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    check(resident_hmc.launch_counts[resident_hmc.KERNEL] == 0,
          "the generic path launched resident_hmc")
    samples = chains.get_samples()
    check(bool(torch.isfinite(samples).all()), "iris generic path: non-finite samples")
    acc = chains.tensor("accepted").float().mean().item()
    z = max_z(pooled_summary(samples), kernel_summary)
    emit({"phase": "generic_vs_kernel", "chains": C_generic, "iterations": iters,
          "burnin": burnin, "seconds": wall, "samples_per_s": C_generic * iters / wall,
          "acceptance_post_burnin": acc, "max_abs_z_pooled_mean_vs_kernel": z, "limit": 5.0,
          "card": card})
    check(z <= 5.0, f"iris: generic path's pooled means differ from the kernel's by {z} SEs")
    check(abs(acc - 0.65) <= 0.15, f"iris generic path: acceptance {acc} outside 0.65 +- 0.15")
    del chains, samples
    torch.cuda.empty_cache()

    # 10. where the time goes on the sample_chains iris path
    torch.cuda.synchronize()
    start = time.perf_counter()
    chains, by_kernel = profiled(lambda: iris_chains(gen))
    wall = time.perf_counter() - start
    busy = sum(by_kernel.values()) / 1e3
    kernel_ms = sum(ms for name, ms in by_kernel.items() if "resident_hmc" in name)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    # the share is taken of phase 7's unprofiled host-clock time of the same call
    emit({"phase": "profile_sample_chains_iris", "chains": chains.num_chains(),
          "iterations": iters, "seconds": iris_wall, "seconds_profiled": wall,
          "device_busy_seconds": busy, "device_busy_share": busy / iris_wall,
          "resident_hmc_ms": kernel_ms, "device_kernels_seen": len(by_kernel),
          "device_ms_by_kernel": {name[:60]: ms for name, ms in top}, "card": card})
    del chains

    # 11. kernels: fused_mlp_vg timed at the iris main path's shape;
    #     resident_hmc at the XOR main path's, where the leapfrog count is fixed
    C = xor_theta0s.shape[0]
    xor_fn = resident_hmc.make_resident_hmc(xor_model, xor.x, xor.y, 0.05, 10, xor_iters,
                                            chain_block=1024, device=device)
    start = time.perf_counter()
    xor_evaluations = xor_fn.plain(args.seed, xor_theta0s)[1]["evaluations"]
    torch.cuda.synchronize()
    xor_plain_ms = 1e3 * (time.perf_counter() - start)
    check(xor_evaluations == C * (1 + 10 * xor_iters), "XOR: unexpected evaluation count")
    xor_ms = event_ms(lambda: xor_fn(args.seed, xor_theta0s), 3)
    xor_b_ms, xor_b_by = bound_ms(resident_work([2, 2, 1], [True, True], False, len(xor.x), C,
                                                xor_evaluations, xor_iters, xor_iters, False),
                                  sm_count)
    ms, plain_ms, b_ms, b_by = timings[("iris_mlp433_ce", 32768)]
    emit({"kernels": [
        {"name": fused_mlp.KERNEL, "route": "cuda", "source": FUSED_SOURCE,
         "replaces": FUSED_REPLACES, "launches": sum(launches.values()),
         "launches_by_path": launches, "max_abs_err": max_abs_err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
         "timed_at": "iris MLP(4,3,3), 32768 chains"},
        {"name": resident_hmc.KERNEL, "route": "cuda", "source": RESIDENT_SOURCE,
         "replaces": RESIDENT_REPLACES, "launches": sum(resident_launches.values()),
         "launches_by_path": resident_launches, "max_abs_err": resident_err, "ms": xor_ms,
         "plain_ms": xor_plain_ms, "bound_ms": xor_b_ms, "bound_by": xor_b_by,
         "library_ms": None,
         "timed_at": "XOR MLP(2,2,1), step 0.05, 10 leapfrog steps, 131072 chains x 256",
         "tuned_iris": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"),
                                resident_timings["iris_tuned_burnin_20"]))}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
