"""Chip check of the PyTorch/CUDA port (``eeyore_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card (Hopper: the
kernels are built for sm_90a). Phases, one JSON line each:

1. build: builds, all at once from ``eeyore_tpu_torch/ops/csrc/``, the fused
   log-posterior kernel ``fused_mlp_vg`` for the three architectures below;
   ``resident_hmc`` for iris MLP(4,3,3) CE (a chain on ``HMC_LANES`` lanes of
   a warp) and XOR MLP(2,2,1) BCE (one thread a chain: 8 padded rows);
   ``resident_hmc_dense`` for XOR MLP(2,2,1); ``resident_walk`` (MH and MALA,
   a chain on ``WALK_LANES`` lanes) for iris MLP(4,3,3) and (its Gibbs move,
   a chain on ``GIBBS_LANES`` lanes caching its rows' activations) iris
   MLP(4,3,2,3), once more with every
   unit split, and XOR MLP(2,2,1) staged;
   ``resident_walk_dense`` for XOR MLP(2,2,1) and MLP(2,3,2,1) at the lanes
   a chain of each move (``WALK_DENSE_LANES``: MH one thread a chain, MALA
   2 lanes, the ladder 4, a row a lane; Gibbs one thread in every build),
   and on one thread a chain (the build of tuning groups that no cluster of
   lane blocks holds), and for
   MLP(2,3,2,1) with one-coordinate Gibbs sub-blocks; ``resident_smc`` for
   XOR MLP(2,2,1) BCE (one thread a particle: 8 padded rows) and iris
   MLP(4,3,3) CE (``SMC_LANES`` lanes a particle); ``resident_smc_closure`` for
   the 2-d mixture of benchmarks/validate_smc_hard.py, its body generated
   from the closure (``ops/closure_trace.py``); ``resident_nuts`` for iris
   MLP(4,3,3) and ``resident_nuts_dense`` for XOR MLP(2,2,1), at tree depth
   3, the dense one also with a diagonal metric (the staged one on
   ``NUTS_LANES`` lanes a chain, and on one thread a chain for XOR's tuning
   groups of 4096 chains). It reports the lane kernels' lanes, occupancy
   targets and the Gibbs cache's choice, the launches of the staged HMC, MH
   and MALA kernels on the iris main paths, of the dense MH and MALA moves
   on configs 1 and 2 and of the SMC pass on iris (lanes, threads, blocks,
   cluster, blocks an SM, SMs covered), each build's registers and
   local-memory (spill) bytes per thread, the Gibbs and
   tempering moves' too (iris MLP(4,3,3) MH and MALA on ``resident_walk``,
   XOR MLP(2,2,1) MH and MALA on ``resident_walk_dense``), the SMC mutation
   kernels' MH and MALA, and the thread-block cluster a population-tuned
   dense run takes (the dense walk's on lanes up to a group of 1024 chains,
   on one thread a chain beyond).
2. kernel vs plain: calls ``fused_mlp_vg``'s wrapper on the card at C =
   32768 and 131072 seeded random chains (the main paths' chain counts) and
   holds it against the plain PyTorch ``make_vg`` on the same inputs (rtol
   2e-5, atol 1e-4; 3e-4 on the 150-row iris case, as tests/test_ops.py::
   compare), for iris MLP(4,3,3) CE, XOR MLP(2,2,1) BCE and MLP(3,4,2,1)
   without biases on layers 0 and 2, a (0.5, 2.0) prior and temperature
   0.3; and times both (the kernel by its device time in ``torch.profiler``,
   and by CUDA events around a launch, which hold the host's launch path).
3. resident vs plain: each whole-loop kernel against its plain version (same
   seed, same inputs, on the card), at its main path's chain count:
   ``resident_hmc`` on untuned iris (step 0.02, 8 leapfrog steps, 20
   iterations, record_extras), untuned XOR (131072 chains, step 0.05, 10
   steps), tuned iris (the dispatch plan of BASELINE.md config 3, and the
   maker's default tuning group, JAX's 2048 chains, a cluster) and tuned XOR
   at the group dispatch gives ``backend="resident"``, which must be JAX's
   4096 chains (a cluster of the build with one thread a chain);
   ``resident_hmc_dense`` on untuned XOR (131072 chains, extras), tuned in
   population groups of 8192 chains (a cluster) and per chain;
   ``resident_walk`` on iris MH (scale 0.1) and MALA (step 0.003), 32768
   chains, extras; ``resident_walk_dense`` on XOR MH MLP(2,2,1) (scale 0.1)
   and MALA MLP(2,3,2,1) (step 0.01), untuned with extras (on lanes), tuned
   in JAX's groups of 8192 and 4096 chains (one thread a chain) and of 1024
   (a cluster of 16 lane blocks); the
   Gibbs moves on iris MLP(4,3,2,3) (scales 0.1, staged), XOR MLP(2,2,1)
   (scales 0.5, dense) and XOR MLP(2,3,2,1) with ``node_subblock_size=[1]*6``
   (dense), and staged on iris MLP(4,3,2,3) with every unit split into two
   sub-blocks and on XOR MLP(2,2,1), 32768 chains x 20 iterations, extras,
   per-sub-block counts, the lane kernels' launches (blocks, SMs covered); the
   tempering moves (ladders of 8 rungs at (i/8)^4, swaps every 5 iterations)
   on iris MALA (step 0.003) and MH (scale 0.1), staged, and XOR MLP(2,2,1)
   MALA (step 0.05) and MH (scale 0.5), dense, 32768 chains x 20 iterations, extras, both count
   columns, each at the chain block that dispatch gives phase 13's main path
   (128 staged, 1024 dense), so at its launch layout, and a staged ladder of
   ``WALK_BLOCK`` rungs (the longest on the kernel; one thread a chain); then the
   equal-temperature pin on the dense XOR ladder: with one temperature on
   every rung every eligible swap is accepted. A chain agrees when all its outputs are within atol 1e-3 + rtol 1e-3 of the
   plain version's; at least 99% of chains must agree on the untuned runs and on
   the tuned runs with 5 burn-in iterations (an accept decision at u ~ rate
   may flip on f32 rounding and part a chain's path), and 99.9% on the
   untuned iris HMC, MH and MALA runs and the untuned dense MALA and
   ladders, whose chains run on lanes; a tuned run with 20
   burn-in iterations, where early long steps make the dynamics chaotic, is
   held statistically instead (pooled means within 5 pooled standard
   errors, acceptance within 0.01). The HMC kernels' evaluation counters
   must equal the plain versions' counts. Each kernel's time is the median
   of three launches after a warm-up (all three reported). Then
   ``resident_smc``, the SMC mutation pass, on 16384 particles drawn from
   the prior, 5 steps at beta 0.3 and 1.0: XOR MALA step 0.05, iris MALA
   step 0.003, iris MH step 0.01, at the chain blocks dispatch gives them;
   and ``resident_smc_closure`` on 16384 draws from the mixture's base, MALA
   and MH step 0.05, against its plain version (the closure by batched
   autograd); a particle agrees when its final theta, pot and accept count
   do, at least 99% must, and the kernel's pot must be the split
   log-likelihood of its own final particles (rtol 1e-4, atol 1e-3); each
   reports its launch (lanes a particle, blocks, SMs covered). Then
   ``resident_nuts`` (iris, step 0.02) and ``resident_nuts_dense`` (XOR, step
   0.1) at depth 3 on 16384 prior draws x 5 iterations, untuned, tuned (3
   burn-in iterations), with a metric and with extras, at the chain blocks
   dispatch gives phase 15's paths: at least 99.9% of chains agree within
   atol 1e-4 + rtol 1e-4 of the plain version, and as many final steps
   within rtol 1e-4 (the kernel leaves them in ``last_info``); the tuned
   iris case is chaotic (its burn-in steps grow tenfold, and a flipped draw
   moves its whole tuning group's step), so at least 97% of its chains and
   75% of its steps must agree, with pooled means within 5 pooled standard
   errors and accept_stat within 0.02, and the plain version's own
   agreement under a one-ulp change of theta0 reported. Then tuned staged
   NUTS on XOR (3 burn-in iterations) at the plan's tuning group for
   ``backend="resident"``, which must be JAX's 4096 chains (the build with
   one thread a chain), held as the tuned iris case is.
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
   steps, 131072 chains x 256) through ``backend="auto"``, which now takes
   ``resident_hmc_dense``, and through ``backend="resident"``; one launch
   each, acceptance in (0.2, 1], pooled means of the two, and of the dense
   run and the generic path at 4096 chains, within 5 pooled standard errors.
9. generic vs kernel: config 3 through ``sample_chains(backend="scan")``
   (the batched-autograd generic path) at 4096 chains; pooled means within
   5 pooled standard errors of phase 7's kernel run.
10. profile, sample_chains: device time by kernel of one iris call of phase
    7, against its host-clock time, and the bound of that launch from its
    evaluation counter.
11. main paths, walks, sample_chains(backend="auto"): BASELINE.md config 1
    (MH scale 0.1, MLP(2,2,1), XOR) and config 2 (MALA step 0.01,
    MLP(2,3,2,1), XOR) on ``resident_walk_dense``, iris MALA (step 0.003) and
    iris MH (scale 0.1) on config 3's MLP(4,3,3) on ``resident_walk``; 32768
    chains x 2048 iterations, 1024 burn-in each. Each checks one launch of
    its kernel, finite samples, pooled means within 5 pooled standard errors
    of the generic path of the same configuration at 4096 chains, and finite
    ``multi_rhat`` / ``multi_ess`` on the first 64 chains; configs 1 and 2
    also post-burn-in acceptance within 0.02 of the one-thread builds'
    (0.875 and 0.999 on the H100, PERF.md). Each reports its launch (lanes a chain,
    blocks, SMs covered).
12. main paths, Gibbs, sample_chains(backend="auto"): BASELINE.md config 4
    (``Gibbs(scales=0.1)``, MLP(4,3,2,3), iris) on ``resident_walk``'s Gibbs
    move and XOR MLP(2,2,1) with ``Gibbs(scales=0.5)`` on
    ``resident_walk_dense``'s; 32768 chains x 2048 iterations, 1024 burn-in.
    Each checks one launch of its kernel, finite samples, pooled means within
    5 pooled standard errors of the generic path at 4096 chains, per-block
    acceptance (the kernel's counts over the kept iterations) within 0.02 of
    the generic path's ``block_acceptance_rate``, finite ``multi_rhat`` /
    ``multi_ess`` on the first 64 chains, and reports the kernel's time
    beside its bound, and beside the time of the same run keeping one
    iteration (what recording costs).
13. main paths, tempering, PowerPosteriorSampler.run(backend="auto",
    all_ladders=True): ladders of 8 rungs, MALA within the rungs, even/odd
    swaps every 10 iterations, 2048 iterations with 1024 burn-in, on XOR
    MLP(2,2,1) (step 0.05; the dense kernel's smallest block, 1024 chains)
    and iris MLP(4,3,3) (step 0.003; the staged kernel's, 128 chains). Each
    checks one launch of its tempering kernel, finite samples, the cold
    rung's pooled means and acceptance within 5 pooled standard errors of the
    generic ladder's (``sample_population`` over 64 independent ladders), and
    reports the within-rung acceptance per rung (and its distance from the
    generic ladder's) and the swap acceptance per pair;
    then each maker is called directly at 32768 chains (4096 ladders) x 2048
    iterations, and at the entry point's one chain block, and its kernel
    timed beside its bound (the median of three launches after a warm-up,
    as phase 12's Gibbs kernels).
14. main paths, SMC, SMCSampler.run(backend="auto"), each over SMC_SEEDS
    seeds beside the generic path (``backend="scan"``) over as many:
    BASELINE.md config 5, the SMC half (XOR MLP(2,2,1), 16384 particles,
    betas (i/20)^4, MALA step 0.05, 5 steps; exactly 20 launches of
    ``resident_smc`` a run); XOR adaptive (MALA step 0.1; the last beta 1,
    the betas rising, log-evidence within 0.1 of config 5's); iris
    MLP(4,3,3) with config 5's ladder and sizes, MALA step 0.003 and MH step
    0.01 (its generic runs on 4096 particles); the 2-d mixture of
    benchmarks/validate_smc_hard.py, a DistributionModel with a base (16384
    particles, adaptive, MALA 0.05, 5 steps, 60 stages at most; exactly one
    launch of ``resident_smc_closure`` a stage, log-evidence within 0.1 of
    0, the weighted share of theta_0 > 0 within 0.05 of 0.5). Config 5 and
    the two iris paths run beside the generic path: weighted posterior means
    agree within 5 standard errors of the difference of the two paths' seed
    means (from the spread over seeds: the weights' ESS does not count what
    resampling shares between particles, and two generic iris runs part by
    hundreds of such ESS errors), log-evidence within 0.1 nats or, where the
    generic path's spread over seeds is larger, 5 times that spread while
    that is at most 0.5 nats; above that the difference is a reading, not a
    check. Each reports its wall time, particle-stage-mutations/s, mutation
    acceptance, resamples and the device's busy share of the wall.
15. main paths, NUTS, sample_chains(backend="auto"): fixed-budget NUTS at
    depth 3 with HMCDATuner(d=0.8) on XOR MLP(2,2,1) (step 0.1, 32768 chains
    x 2048, 1024 burn-in; benchmarks/validate_dense_nuts.py:42-56), which goes
    to ``resident_nuts_dense``, and on iris MLP(4,3,3) (step 0.02, 16384 x
    2048; validate_dense_nuts.py:166-183), which goes to ``resident_nuts``;
    then ``NUTS(max_depth="auto")`` on XOR without and with mass_adapt
    (benchmarks/validate_auto_nuts.py:62-110): the probe inside sample_chains,
    then the dense kernel at the probed depth and step (and frozen metric).
    Each checks one launch of its kernel (in the timed run and in the
    profiled one), finite samples and a post-burn-in accept_stat within 0.02
    of the tuner's target 0.8; holds its own build (the plan's depth, step,
    metric and tuner, 16384 of its inits x 5 iterations with 3 burn-in)
    against the plain version, as phase 3 holds the NUTS cases; runs the
    probe of an auto path again from the same seed and checks that it gives
    the same depth, step and metric; and holds kernel runs
    against the generic path at 4096 chains, both sides cut to 384
    iterations with 192 burn-in (the generic NUTS takes 12-50 ms an
    iteration): the same kernel object, pooled means within 5 pooled
    standard errors (the two tuners differ: one step a group on the kernel,
    one a chain on the generic path, so accept_stat is a reading there), and
    untuned fixed-budget NUTS at the plan's step, depth and metric, pooled
    means within 5 pooled standard errors and accept_stat within 0.02. It
    reports the plan, the probed depth, step and metric, the probe's wall
    time, samples/s, the device's busy share (traced where the profiler
    records the kernel, else null beside an estimate from the kernel's
    CUDA-event time), the divergence rate and the kernel's time beside its
    bound.
16. kernels: each kernel's launches on the main paths, its error against its
    plain version, its time, the plain version's time and its bound, and
    for ``resident_hmc``, ``resident_walk``, ``resident_walk_dense`` and
    ``resident_smc`` the lanes a chain of each build.

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
DENSE_SOURCE = "eeyore_tpu_torch/ops/csrc/resident_hmc_dense.cu"
DENSE_REPLACES = "eeyore_tpu/ops/resident_hmc_dense.py:303"
WALK_SOURCE = "eeyore_tpu_torch/ops/csrc/resident_walk.cu"
WALK_REPLACES = "eeyore_tpu/ops/resident_walk.py:166"
WALK_DENSE_SOURCE = "eeyore_tpu_torch/ops/csrc/resident_walk_dense.cu"
WALK_DENSE_REPLACES = "eeyore_tpu/ops/resident_walk_dense.py:125"
GIBBS_REPLACES = "eeyore_tpu/ops/resident_walk.py:281 (the Gibbs move of :166)"
GIBBS_DENSE_REPLACES = "eeyore_tpu/ops/resident_walk_dense.py:240 (the Gibbs move of :125)"
TEMPERING_REPLACES = ("eeyore_tpu/ops/resident_tempering.py:178 (the tempering move of "
                      "resident_walk.py:166)")
TEMPERING_DENSE_REPLACES = ("eeyore_tpu/ops/resident_tempering_dense.py:150 (the tempering "
                            "move of resident_walk_dense.py:125)")
SMC_SOURCE = "eeyore_tpu_torch/ops/csrc/resident_smc.cu"
SMC_REPLACES = "eeyore_tpu/ops/resident_smc.py:329"
SMC_CLOSURE_SOURCE = "eeyore_tpu_torch/ops/csrc/resident_smc_closure.cu"
SMC_CLOSURE_REPLACES = "eeyore_tpu/ops/resident_smc.py:315"
NUTS_SOURCE = "eeyore_tpu_torch/ops/csrc/resident_nuts.cu"
NUTS_REPLACES = "eeyore_tpu/ops/resident_nuts.py:371"
NUTS_DENSE_SOURCE = "eeyore_tpu_torch/ops/csrc/resident_nuts_dense.cu"
NUTS_DENSE_REPLACES = "eeyore_tpu/ops/resident_nuts_dense.py:360"
# the NUTS kernels' checks and main paths: tree depth, chains x iterations of
# a check, agreement tolerances (a multinomial or merge draw at its threshold
# may flip on f32 rounding and part a chain)
NUTS_DEPTH, NUTS_CHECK_CHAINS, NUTS_CHECK_ITERS, NUTS_CHECK_BURNIN = 3, 16384, 5, 3
NUTS_ATOL = NUTS_RTOL = 1e-4
NUTS_MIN_AGREEING = 0.999
# a chaotic (tuned, staged) check: the least share of chains, and of final
# steps, that agree with the plain version
NUTS_MIN_AGREEING_CHAOTIC, NUTS_MIN_STEPS_AGREEING = 0.97, 0.75
# the NUTS main paths' comparison with the generic path: its chains, and the
# iterations (burn-in) that both sides run
NUTS_GENERIC_CHAINS, NUTS_GENERIC_ITERS, NUTS_GENERIC_BURNIN = 4096, 384, 192
# post-burn-in accept_stat: of a tuned kernel run against the tuner's target,
# and of the kernel against the generic path at one step
NUTS_ACCEPT_TOL = 0.02
# the SMC main paths: particles, mutation steps, seeds a path
SMC_PARTICLES, SMC_STEPS, SMC_SEEDS = 16384, 5, 16
# the ladders of the tempering phases: rungs, swap period of the kernel checks
# and of the main paths
LADDER_RUNGS, CHECK_BETWEEN, MAIN_BETWEEN = 8, 5, 10
# per-block acceptance of a Gibbs kernel run against its generic path
GIBBS_BLOCK_ACCEPTANCE_TOL = 0.02
# node sub-blocks that split every unit of iris MLP(4,3,2,3) (5, 4 and 3
# coordinates a unit), so that the staged Gibbs move updates partial units
IRIS4323_SPLIT_UNITS = [3, 3, 3, 2, 2, 2, 2, 2]
# resident vs plain: a chain agrees when every value it recorded is within
# RESIDENT_ATOL + RESIDENT_RTOL * |plain value|; at least RESIDENT_MIN_AGREEING
# of the chains must agree
RESIDENT_ATOL = 1e-3
RESIDENT_RTOL = 1e-3
RESIDENT_MIN_AGREEING = 0.99
# the untuned checks of the staged HMC, MH and MALA kernels on lanes: the
# least share of chains that agree
RESIDENT_LANE_MIN_AGREEING = 0.999
LANE_CASES = ("iris_untuned_extras", "iris_mh_extras", "iris_mala_extras",
              "iris_tempering_mala_extras", "iris_tempering_mh_extras",
              "xor_mlp2321_mala_dense_extras", "xor_tempering_mala_dense_extras",
              "xor_tempering_mh_dense_extras")
# configs 1 and 2 (dense MH and MALA on XOR): post-burn-in acceptance of the
# one-thread builds (H100, PERF.md section 5), which the lane builds
# must keep within WALK_ACCEPTANCE_TOL
WALK_ACCEPTANCE = {"config1_mh_xor": 0.875, "config2_mala_xor_mlp2321": 0.999}
WALK_ACCEPTANCE_TOL = 0.02
# config 3's tuning group on the card (dispatch's chain block for iris HMC)
IRIS_HMC_BLOCK = 256


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


def event_times(fn, reps=3, warmup=1):
    """``reps`` calls of ``fn()`` after ``warmup`` calls, each timed by CUDA
    events around it: (the median ms, [ms of each call])."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2], times


def vg_work(dims, bias, ce, n_rows, C, with_grad=True):
    """(bytes, f32 operations, special-function operations) that the fused
    value-and-gradient needs for C chains over n_rows data rows, counted
    from the code (``csrc/mlp_vg.cuh``; without the gradient, its value-only
    entry). Bytes: theta read once, value and gradient written once, the
    data and prior read once. Operations: a multiply-add is 2; an add,
    subtract, multiply or max is 1; exp, log, log1p and the sigmoid's
    reciprocal are one special-function operation each."""
    L = len(dims) - 1
    P = sum(dims[l] * dims[l + 1] + (dims[l + 1] if bias[l] else 0) for l in range(L))
    k = dims[-1]
    layer_macs = [dims[l] * dims[l + 1] for l in range(L)]
    bias_units = sum(dims[l + 1] for l in range(L) if bias[l])
    sigmoid_units = sum(dims[1:-1]) + (0 if ce else k)
    sfu = 2 * sigmoid_units                       # exp and reciprocal
    if not with_grad:
        ops = 2 * sum(layer_macs) + bias_units + 2 * sigmoid_units
        if ce:
            ops += (k - 1) + k + (k - 1) + 1 + 2 * k + 2  # max, shifts, sum, lse, picked, ll
            sfu += k + 1                          # k exps, log
        else:
            ops += k * (3 + 4)                    # softplus, ll
            sfu += 2 * k
        n_bytes = 4 * (P * C + C + n_rows * (dims[0] + k + 1) + 2 * P)
        return n_bytes, C * (n_rows * ops + 4 * P + 2), C * n_rows * sfu
    macs = 2 * sum(layer_macs) + sum(layer_macs[1:])  # forward, weight grads, deltas
    ops = 2 * macs + 2 * bias_units               # bias add and bias gradient
    ops += 2 * sigmoid_units                      # 1 + exp(-z), negation
    ops += 3 * sum(dims[1:-1])                    # delta * a * (1 - a)
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


def resident_work(dims, bias, ce, n_rows, C, evaluations, num_iters, kept, extras,
                  eval_work=None):
    """(bytes, operations, special-function operations) that ``resident_hmc``
    (and ``resident_hmc_dense``) needs: ``evaluations`` single-chain
    value-and-gradient evaluations (the initial one and one per leapfrog
    step, as this run's trajectories needed: the kernel counts them), per
    leapfrog step the position and momentum updates (4P), per iteration
    ceil(P/2) + 1 Threefry calls, ceil(P/2) Box-Muller pairs, the energies
    (4P + 4) and the accept (exp: 1 special-function operation); bytes:
    theta0 read, the data once (none when it is part of the code), the
    samples (kept x (P or P+2) x C), the final theta and the accept counts
    written once. ``eval_work``: (operations, special-function operations)
    of one evaluation, where the dense body's own count replaces
    ``vg_work``'s."""
    P = sum(dims[l] * dims[l + 1] + (dims[l + 1] if bias[l] else 0)
            for l in range(len(dims) - 1))
    vg_ops, vg_sfu = eval_work or vg_work(dims, bias, ce, n_rows, 1)[1:]
    pairs = (P + 1) // 2
    per_iter_ops = (pairs + 1) * THREEFRY_OPS + pairs * BOX_MULLER_OPS + 4 * P + 4
    ops = evaluations * (vg_ops + 4 * P) + C * num_iters * per_iter_ops
    sfu = evaluations * vg_sfu + C * num_iters * (pairs * BOX_MULLER_SFU + 1)
    rows = P + 2 if extras else P
    data = 0 if eval_work else n_rows * (dims[0] + dims[-1] + 1) + 2 * P
    n_bytes = 4 * (P * C + data + kept * rows * C + P * C + C)
    return n_bytes, ops, sfu


def walk_work(P, C, num_iters, kept, extras, mala, eval_work, data_floats):
    """(bytes, operations, special-function operations) that a walk kernel
    needs: C * (1 + num_iters) evaluations (value only for MH, value and
    gradient for MALA) of ``eval_work`` = (operations, special-function
    operations) each, per iteration ceil(P/2) + 1 Threefry calls, ceil(P/2)
    Box-Muller pairs, the proposal (MH: 2P; MALA: the drift, the reverse
    distance and |z|^2, 11P + 5) and the accept (log: 1 special-function
    operation); bytes: theta0 read, ``data_floats`` of data read once, the
    samples, the final theta and the accept counts written once."""
    ev_ops, ev_sfu = eval_work
    pairs = (P + 1) // 2
    move_ops = 11 * P + 5 if mala else 2 * P + 1
    per_iter_ops = (pairs + 1) * THREEFRY_OPS + pairs * BOX_MULLER_OPS + move_ops + 1
    evaluations = C * (1 + num_iters)
    ops = evaluations * ev_ops + C * num_iters * per_iter_ops
    sfu = evaluations * ev_sfu + C * num_iters * (pairs * BOX_MULLER_SFU + 1)
    rows = P + 2 if extras else P
    n_bytes = 4 * (P * C + data_floats + kept * rows * C + P * C + C)
    return n_bytes, ops, sfu


def gibbs_unit_work(dims, bias, ce, n_rows, l):
    """(operations, special-function operations) per chain of one
    incremental Gibbs update of a unit of layer l on staged data
    (``mlp_math.make_incremental_gibbs``, the TPU kernel's work): the unit,
    every layer strictly downstream of it (a hidden unit moves all output
    units; an output unit only itself) and the loss, on each row, counted as
    ``vg_work`` counts the value-only body, and the prior once."""
    L = len(dims) - 1
    k = dims[-1]
    P = sum(dims[i] * dims[i + 1] + (dims[i + 1] if bias[i] else 0) for i in range(L))

    def unit(i):
        return 2 * dims[i] + (1 if bias[i] else 0)

    ops = sfu = 0
    outputs = 1
    if l < L - 1:
        ops, sfu, outputs = unit(l) + 2, 2, k         # the unit and its sigmoid
        for i in range(l + 1, L - 1):
            ops += dims[i + 1] * (unit(i) + 2)
            sfu += 2 * dims[i + 1]
    ops += outputs * unit(L - 1)
    if ce:
        ops += (k - 1) + k + (k - 1) + 1 + 2 * k + 2  # the whole head from the cached logits
        sfu += k + 1
    else:
        ops += 7 * outputs                            # softplus and y z - softplus per moved unit
        sfu += 2 * outputs
    return n_rows * ops + 4 * P + 2 + (0 if ce else k), n_rows * sfu


def gibbs_work(P, C, num_iters, kept, extras, sweep, init_work, data_floats):
    """(bytes, operations, special-function operations) that a Gibbs kernel
    needs: one value-only evaluation per chain (``init_work``), then per
    iteration, for each sub-block of ``sweep`` = [(width, (operations,
    special-function operations) of its incremental update)], the update,
    ceil(w/2) + 1 Threefry calls, ceil(w/2) Box-Muller pairs, the proposal
    (2w) and the accept (a subtraction, a compare; log: 1 special-function
    operation); bytes: theta0 read, ``data_floats`` of data and the scales
    read once, the samples, the final theta and the [B, C] accept counts
    written once."""
    ops = sfu = 0
    for width, (u_ops, u_sfu) in sweep:
        pairs = (width + 1) // 2
        ops += u_ops + (pairs + 1) * THREEFRY_OPS + pairs * BOX_MULLER_OPS + 2 * width + 2
        sfu += u_sfu + pairs * BOX_MULLER_SFU + 1
    B = len(sweep)
    rows = P + 2 if extras else P
    n_bytes = 4 * (P * C + data_floats + B + kept * rows * C + P * C + B * C)
    return (n_bytes, C * (init_work[0] + num_iters * ops),
            C * (init_work[1] + num_iters * sfu))


def swap_rounds(num_rungs, num_iters, between_step, first=0):
    """Lower members of a ladder over the swap rounds of iterations [first,
    num_iters): {rung: rounds in which it is the lower member of a pair}."""
    rounds = [t for t in range(first, num_iters) if t % between_step == 0]
    return {r: sum((t // between_step) % 2 == r % 2 for t in rounds)
            for r in range(num_rungs - 1)}


def tempering_work(P, C, num_iters, kept, extras, mala, eval_work, data_floats, num_rungs,
                   between_step):
    """(bytes, operations, special-function operations) that a tempering
    kernel needs: ``walk_work`` of its within-rung moves, plus the
    temperature at each accept test (MALA: the tempered drift and reverse
    drift, 2P + 1; MH: 1), and per lower member of a swap round one Threefry
    call, the swap log-rate and test (4 operations and a log); bytes: the
    rung temperatures and the second count row."""
    n_bytes, ops, sfu = walk_work(P, C, num_iters, kept, extras, mala, eval_work, data_floats)
    lower = C // num_rungs * sum(swap_rounds(num_rungs, num_iters, between_step).values())
    ops += C * num_iters * (2 * P + 1 if mala else 1) + lower * (THREEFRY_OPS + 4)
    return n_bytes + 4 * (num_rungs + C), ops, sfu + lower


def smc_work(P, N, num_steps, mala, eval_work, data_floats):
    """(bytes, operations, special-function operations) that the SMC
    mutation kernel needs: N * (1 + num_steps) split evaluations of
    ``eval_work`` each (value and combined gradient for MALA, value only for
    MH) and the target lp + beta ll (2 operations), per step ceil(P/2) + 1
    Threefry calls, ceil(P/2) Box-Muller pairs, the proposal and the accept
    as ``walk_work`` counts them; bytes: theta read once, ``data_floats`` of
    data read once, the final theta, pot and accept counts written once."""
    ev_ops, ev_sfu = eval_work
    pairs = (P + 1) // 2
    move_ops = 11 * P + 5 if mala else 2 * P + 1
    per_step_ops = (pairs + 1) * THREEFRY_OPS + pairs * BOX_MULLER_OPS + move_ops + 1
    evaluations = N * (1 + num_steps)
    ops = evaluations * (ev_ops + 2) + N * num_steps * per_step_ops
    sfu = evaluations * ev_sfu + N * num_steps * (pairs * BOX_MULLER_SFU + 1)
    n_bytes = 4 * (P * N + data_floats + P * N + 2 * N)
    return n_bytes, ops, sfu


def nuts_work(P, C, num_iters, kept, extras, depth, eval_work, data_floats):
    """(bytes, operations, special-function operations) that a fixed-budget
    NUTS kernel needs. Every leaf runs, so the evaluations are exact: C (1 +
    num_iters (2^D - 1)) of ``eval_work`` = (operations, special-function
    operations) each. Per leaf the leapfrog (7P), the kinetic energy (3P),
    the weight, statistic, logaddexp and multinomial test (10 operations;
    exp, exp, log1p, log); per iteration the U-turn checks (2^d - 1 inside
    the subtree of depth d, and the whole trajectory's once a depth, 7P
    each), per depth the merge (10 operations; exp, log1p, log), ceil(P/2)
    Box-Muller pairs and ceil(P/2) + 2^D - 1 + 2D Threefry words, the momenta
    and logp0 (4P + 2). Bytes: theta0, ``data_floats`` of data and the
    metric (2P) read once; the samples, the final theta and the two [C] sums
    written once."""
    ev_ops, ev_sfu = eval_work
    leaves = 2 ** depth - 1
    checks = sum(2 ** d - 1 for d in range(depth)) + depth
    pairs = (P + 1) // 2
    words = pairs + leaves + 2 * depth
    evaluations = C * (1 + num_iters * leaves)
    per_iter_ops = (words * THREEFRY_OPS + pairs * BOX_MULLER_OPS + 4 * P + 2
                    + leaves * (10 * P + 10) + checks * 7 * P + depth * 10)
    per_iter_sfu = pairs * BOX_MULLER_SFU + leaves * 4 + depth * 3
    ops = evaluations * ev_ops + C * num_iters * per_iter_ops
    sfu = evaluations * ev_sfu + C * num_iters * per_iter_sfu
    rows = P + 2 if extras else P
    n_bytes = 4 * (P * C + data_floats + 2 * P + kept * rows * C + P * C + 2 * C)
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


def chain_agreement(got, want, chain_dim, atol=RESIDENT_ATOL, rtol=RESIDENT_RTOL):
    """(mask [C] of the chains whose every value agrees, max abs error over
    them) of two outputs whose dimension ``chain_dim`` is the chain."""
    C = got.shape[chain_dim]
    got = got.movedim(chain_dim, 0).reshape(C, -1).double()
    want = want.movedim(chain_dim, 0).reshape(C, -1).double()
    diff = (got - want).abs()
    bad = (diff > atol + rtol * want.abs()) | ~torch.isfinite(got)
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

    from eeyore_tpu_torch.chains import ChainList, ChainLists
    from eeyore_tpu_torch.datasets import XYDataset
    from eeyore_tpu_torch.models import MLP, DistributionModel, IIDNormalPrior, loss_functions, mlp
    from eeyore_tpu_torch.ops import (
        fused_mlp,
        resident_hmc,
        resident_hmc_dense,
        resident_nuts,
        resident_nuts_dense,
        resident_smc,
        resident_walk,
        resident_walk_dense,
    )
    from eeyore_tpu_torch.ops import kernel_prng
    from eeyore_tpu_torch.ops.fused_hmc import FusedHMC
    from eeyore_tpu_torch.ops.resident_tempering import make_resident_tempering
    from eeyore_tpu_torch.ops.resident_tempering_dense import make_resident_tempering_dense
    from eeyore_tpu_torch.ops.mlp_dense import dense_work, gibbs_dense_work
    from eeyore_tpu_torch.ops.mlp_math import extract_arch, make_vg, prepare_data
    from eeyore_tpu_torch.samplers import (
        HMC,
        MALA,
        NUTS,
        Gibbs,
        MetropolisHastings,
        PowerPosteriorSampler,
        SMCSampler,
        sample_chains,
        sample_population,
    )
    from eeyore_tpu_torch.samplers.dispatch import resolve_backend, resolve_smc, resolve_tempering
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
    xor2321_model = make_model([2, 3, 2, 1], "binary_classification")
    iris4323_model = make_model([4, 3, 2, 3], "multiclass_classification",
                                [mlp.sigmoid, mlp.sigmoid, None])
    xor2321_subblocks = [1] * xor2321_model.num_par_blocks()
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
    empty = (np.zeros((1, 0)), np.zeros((1, 0)))
    mix_mu, mix_s, mix_base = 3.0, 0.25, 3.0  # benchmarks/validate_smc_hard.py:177-201

    def mixture_log_pdf(t, x, y):
        """Equal-weight normalized 2-d mixture of N((+-mu, 0), s^2 I)."""
        c = -math.log(2 * math.pi * mix_s ** 2) - math.log(2.0)
        centre = torch.tensor([mix_mu, 0.0], dtype=t.dtype, device=t.device)
        d1, d2 = ((t - centre) ** 2).sum(-1), ((t + centre) ** 2).sum(-1)
        return torch.logaddexp(c - 0.5 * d1 / mix_s ** 2, c - 0.5 * d2 / mix_s ** 2)

    def mixture_base(t):
        return -math.log(2 * math.pi * mix_base ** 2) - 0.5 * (t * t).sum(-1) / mix_base ** 2

    def mixture_init(g, n):
        return mix_base * torch.randn((n, 2), generator=g, device=g.device)

    mixture = DistributionModel(mixture_log_pdf, 2, dtype=torch.float32, device=device)

    # the lanes a chain of each dense move on XOR's rows, and that move's build
    DENSE_MOVES = ("mh", "mala", "ladder")

    def dense_lanes_of(move):
        return resident_walk_dense.dense_lanes(len(xor.x), move)

    def walk_dense_lib(name, move):
        return walk_dense_libs[f"{name}_l{dense_lanes_of(move)}"]

    # 1. build, every library at once
    start = time.perf_counter()
    nuts_metric = {"iris": np.linspace(0.5, 2.0, iris_model.num_params),
                   "xor": np.linspace(0.5, 2.0, xor_model.num_params)}
    iris_rows = prepare_data(iris_model, iris.x, iris.y)[0].shape[0]
    xor_rows = prepare_data(xor_model, xor.x, xor.y)[0].shape[0]
    with concurrent.futures.ThreadPoolExecutor(len(cases) + 18) as pool:
        futures = [pool.submit(fused_mlp.load_kernel, model) for _, model, _, _, _ in cases]
        resident_futures = [pool.submit(resident_hmc.load_kernel, model,
                                        resident_hmc.chain_lanes(rows, IRIS_HMC_BLOCK, True))
                            for (_, model), rows in zip(resident_cases, (iris_rows, xor_rows))]
        dense_future = pool.submit(resident_hmc_dense.load_kernel, xor_model, xor.x, xor.y)
        walk_future = pool.submit(resident_walk.load_kernel, iris_model,
                                  lanes=resident_walk.chain_lanes(iris_rows))
        # the ladder move of a ladder of WALK_BLOCK rungs: one thread a chain
        long_ladder_future = pool.submit(
            resident_walk.load_kernel, iris_model, lanes=resident_walk.chain_lanes(iris_rows),
            ladder_lanes=resident_walk.tempering_lanes(iris_rows, resident_walk.WALK_BLOCK,
                                                       resident_walk.WALK_BLOCK))
        gibbs_future = pool.submit(resident_walk.load_kernel, iris4323_model, None, iris_rows)
        gibbs_split_future = pool.submit(resident_walk.load_kernel, iris4323_model,
                                         IRIS4323_SPLIT_UNITS, iris_rows)
        gibbs_xor_future = pool.submit(resident_walk.load_kernel, xor_model, None, xor_rows)
        gibbs_sub_future = pool.submit(resident_walk_dense.load_kernel, xor2321_model, xor.x,
                                       xor.y, xor2321_subblocks)
        # the builds of each dense move's lanes (Gibbs on one thread a chain
        # in every build) and of one thread a chain, which tuned groups beyond
        # a cluster of lane blocks take
        walk_dense_futures = {
            f"{name}_l{lanes}": pool.submit(resident_walk_dense.load_kernel, model, xor.x, xor.y,
                                            lanes=lanes)
            for name, model in (("xor_mlp221_bce", xor_model),
                                ("xor_mlp2321_bce", xor2321_model))
            for lanes in sorted({1} | {dense_lanes_of(move) for move in DENSE_MOVES})}
        smc_futures = {name: pool.submit(resident_smc.load_kernel, model,
                                         resident_smc.smc_lanes(rows))
                       for name, model, rows in (("xor_mlp221_bce", xor_model, xor_rows),
                                                 ("iris_mlp433_ce", iris_model, iris_rows))}
        smc_futures["mixture_2d"] = pool.submit(
            lambda: resident_smc.load_closure_kernel(resident_smc.closure_programs(
                mixture, *empty, mixture_base, device)))
        nuts_futures = {
            "iris_mlp433_ce": pool.submit(resident_nuts.load_kernel, iris_model, NUTS_DEPTH,
                                          resident_nuts.NUTS_LANES),
            "xor_mlp221_bce_one_thread": pool.submit(resident_nuts.load_kernel, xor_model,
                                                     NUTS_DEPTH, 1),
            "xor_mlp221_bce_dense": pool.submit(resident_nuts_dense.load_kernel, xor_model,
                                                xor.x, xor.y, NUTS_DEPTH),
            "xor_mlp221_bce_dense_metric": pool.submit(
                resident_nuts_dense.load_kernel, xor_model, xor.x, xor.y, NUTS_DEPTH,
                nuts_metric["xor"])}
        libs = [f.result() for f in futures]
        resident_libs = [f.result() for f in resident_futures]
        dense_lib = dense_future.result()
        walk_lib = walk_future.result()
        long_ladder_lib = long_ladder_future.result()
        gibbs_lib = gibbs_future.result()
        gibbs_split_lib = gibbs_split_future.result()
        gibbs_xor_lib = gibbs_xor_future.result()
        gibbs_sub_lib = gibbs_sub_future.result()
        walk_dense_libs = {name: f.result() for name, f in walk_dense_futures.items()}
        smc_libs = {name: f.result() for name, f in smc_futures.items()}
        nuts_libs = {name: f.result() for name, f in nuts_futures.items()}
    build_seconds = time.perf_counter() - start
    dense_groups = {}
    for cb in (8192, 4096, 2048, 1024):
        try:
            dense_groups[cb] = resident_hmc_dense.group_shape(dense_lib, cb)
        except ValueError as err:
            dense_groups[cb] = str(err)
    walk_dense_resources, walk_dense_groups = {}, {}
    for name, lib in walk_dense_libs.items():
        for move in ("mh", "mala", "tempering_mh", "tempering_mala"):
            walk_dense_resources[f"{name}_{move}"] = dict(
                resident_walk_dense.kernel_resources(lib, move),
                lanes=lib.resident_walk_dense_lanes())
        for move in ("mh", "mala"):
            for cb in (8192, 4096, 2048, 1024):
                try:
                    shape = resident_walk_dense.walk_shape(lib, move, cb, grouped=True)
                except ValueError as err:
                    shape = str(err)
                walk_dense_groups[f"{name}_{move}_{cb}"] = shape
    gibbs_resources = {
        "iris_mlp4323_ce": dict(resident_walk.kernel_resources(gibbs_lib, "gibbs"),
                                **resident_walk.gibbs_layout(gibbs_lib)),
        "iris_mlp4323_ce_split_units": dict(
            resident_walk.kernel_resources(gibbs_split_lib, "gibbs"),
            **resident_walk.gibbs_layout(gibbs_split_lib)),
        "xor_mlp221_bce_staged": dict(resident_walk.kernel_resources(gibbs_xor_lib, "gibbs"),
                                      **resident_walk.gibbs_layout(gibbs_xor_lib)),
        "xor_mlp221_bce": resident_walk_dense.kernel_resources(
            walk_dense_lib("xor_mlp221_bce", "mh"), "gibbs"),
        "xor_mlp2321_bce_one_coordinate_sub_blocks": resident_walk_dense.kernel_resources(
            gibbs_sub_lib, "gibbs")}
    tempering_resources = {
        f"iris_mlp433_ce_{move}": dict(
            resident_walk.kernel_resources(walk_lib, f"tempering_{move}"),
            lanes=walk_lib.resident_walk_tempering_lanes())
        for move in ("mh", "mala")}
    tempering_resources.update({
        f"iris_mlp433_ce_{move}_{resident_walk.WALK_BLOCK}_rungs": dict(
            resident_walk.kernel_resources(long_ladder_lib, f"tempering_{move}"),
            lanes=long_ladder_lib.resident_walk_tempering_lanes())
        for move in ("mh", "mala")})
    tempering_resources.update({
        f"xor_mlp221_bce_{move}": dict(
            resident_walk_dense.kernel_resources(walk_dense_lib("xor_mlp221_bce", "ladder"),
                                                 f"tempering_{move}"),
            lanes=walk_dense_lib("xor_mlp221_bce", "ladder").resident_walk_dense_lanes())
        for move in ("mh", "mala")})
    nuts_resources = {
        name: (resident_nuts_dense if "dense" in name else resident_nuts).kernel_resources(lib)
        for name, lib in nuts_libs.items()}
    for name in ("iris_mlp433_ce", "xor_mlp221_bce_one_thread"):
        nuts_resources[name]["lanes"] = nuts_libs[name].resident_nuts_lanes()
    nuts_groups = {}
    for cb in (8192, 4096, 2048, 1024):
        try:
            nuts_groups[f"{resident_nuts_dense.KERNEL}_xor_{cb}"] = resident_nuts_dense.group_shape(
                nuts_libs["xor_mlp221_bce_dense"], cb)
        except ValueError as err:
            nuts_groups[f"{resident_nuts_dense.KERNEL}_xor_{cb}"] = str(err)
    for cb in (256, 512, 1024):
        try:
            nuts_groups[f"{resident_nuts.KERNEL}_iris_{cb}"] = resident_nuts.group_shape(
                nuts_libs["iris_mlp433_ce"], cb, iris_rows)
        except ValueError as err:
            nuts_groups[f"{resident_nuts.KERNEL}_iris_{cb}"] = str(err)
    # the staged HMC, MH and MALA launches of the iris main paths: config 3's
    # tuned groups of IRIS_HMC_BLOCK chains, the walks' chain blocks of 4096
    lane_launches = {
        f"{resident_hmc.KERNEL}_iris_tuned_{IRIS_HMC_BLOCK}": resident_hmc.hmc_launch(
            resident_libs[0], 32768, IRIS_HMC_BLOCK, iris_rows, True, sm_count),
        f"{resident_hmc.KERNEL}_xor_untuned_1024": resident_hmc.hmc_launch(
            resident_libs[1], 131072, 1024, xor_rows, False, sm_count)}
    lane_launches.update({
        f"{resident_walk.KERNEL}_iris_{move}_4096": resident_walk.walk_launch(
            walk_lib, move, 32768, 4096, iris_rows, sm_count) for move in ("mh", "mala")})
    # configs 1 and 2 (dispatch's chain blocks of 8192) and the SMC pass on
    # iris (16384 particles)
    lane_launches.update({
        f"{resident_walk_dense.KERNEL}_{name}_8192": resident_walk_dense.walk_launch(
            walk_dense_lib(name, move), move, 32768, 8192, False, sm_count)
        for name, move in (("xor_mlp221_bce", "mh"), ("xor_mlp2321_bce", "mala"))})
    lane_launches.update({
        f"{resident_smc.KERNEL}_{name}_{mutation}": resident_smc.smc_launch(
            smc_libs[name], mutation, SMC_PARTICLES, rows, sm_count)
        for name, rows in (("iris_mlp433_ce", iris_rows), ("xor_mlp221_bce", xor_rows))
        for mutation in ("MALA", "MH")})
    emit({"phase": "build",
          "kernels": [fused_mlp.KERNEL, resident_hmc.KERNEL, resident_hmc_dense.KERNEL,
                      resident_walk.KERNEL, resident_walk_dense.KERNEL, resident_walk.GIBBS_KERNEL,
                      resident_walk_dense.GIBBS_KERNEL, resident_walk.TEMPERING_KERNEL,
                      resident_walk_dense.TEMPERING_KERNEL, resident_smc.KERNEL,
                      resident_smc.CLOSURE_KERNEL, resident_nuts.KERNEL,
                      resident_nuts_dense.KERNEL],
          "sources": [FUSED_SOURCE, RESIDENT_SOURCE, DENSE_SOURCE, WALK_SOURCE,
                      WALK_DENSE_SOURCE, SMC_SOURCE, SMC_CLOSURE_SOURCE, NUTS_SOURCE,
                      NUTS_DENSE_SOURCE],
          "nuts_depth": NUTS_DEPTH,
          "lane_settings": {
              resident_walk.GIBBS_KERNEL: {"lanes": resident_walk.GIBBS_LANES,
                                           "min_blocks": resident_walk.GIBBS_MIN_BLOCKS,
                                           "cache_budget": resident_walk.GIBBS_CACHE_BUDGET},
              resident_nuts.KERNEL: {"lanes": resident_nuts.NUTS_LANES,
                                     "min_blocks": resident_nuts.NUTS_MIN_BLOCKS,
                                     "lane_group_cap": resident_nuts.LANE_GROUP_CAP},
              resident_hmc.KERNEL: {"lanes": resident_hmc.HMC_LANES,
                                    "min_blocks": resident_hmc.HMC_MIN_BLOCKS,
                                    "lane_min_rows": resident_hmc.LANE_MIN_ROWS},
              resident_walk.KERNEL: {"lanes": resident_walk.WALK_LANES,
                                     "min_blocks": resident_walk.WALK_MIN_BLOCKS,
                                     "lane_min_rows": resident_hmc.LANE_MIN_ROWS},
              resident_walk.TEMPERING_KERNEL: {"lanes": resident_walk.TEMPERING_LANES,
                                               "min_blocks": resident_walk.TEMPERING_MIN_BLOCKS,
                                               "block": resident_walk.TEMPERING_BLOCK},
              resident_nuts_dense.KERNEL: {"bound": resident_nuts_dense.NUTS_DENSE_BOUND},
              resident_walk_dense.KERNEL: {"lanes": resident_walk_dense.WALK_DENSE_LANES,
                                           "min_blocks": resident_walk_dense.WALK_DENSE_MIN_BLOCKS,
                                           "block": resident_walk_dense.WALK_DENSE_BLOCK},
              resident_smc.KERNEL: {"lanes": resident_smc.SMC_LANES,
                                    "min_blocks": resident_smc.SMC_MIN_BLOCKS,
                                    "block": resident_smc.SMC_LANE_BLOCK,
                                    "lane_min_rows": resident_hmc.LANE_MIN_ROWS}},
          "lane_launches": lane_launches,
          "seconds": build_seconds,
          "resources": {fused_mlp.KERNEL: {name: fused_mlp.kernel_resources(lib)
                                           for (name, *_), lib in zip(cases, libs)},
                        resident_hmc.KERNEL: {name: dict(resident_hmc.kernel_resources(lib),
                                                         lanes=lib.resident_hmc_lanes())
                                              for (name, _), lib in zip(resident_cases,
                                                                        resident_libs)},
                        resident_hmc_dense.KERNEL: {
                            "xor_mlp221_bce": resident_hmc_dense.kernel_resources(dense_lib)},
                        resident_walk.KERNEL: {
                            f"iris_mlp433_ce_{move}": dict(
                                resident_walk.kernel_resources(walk_lib, move),
                                lanes=walk_lib.resident_walk_lanes())
                            for move in ("mh", "mala")},
                        resident_walk_dense.KERNEL: walk_dense_resources,
                        "gibbs_moves": gibbs_resources,
                        "tempering_moves": tempering_resources,
                        resident_smc.KERNEL: {
                            f"{name}_{mutation}": dict(resident_smc.kernel_resources(lib, mutation),
                                                       lanes=lib.resident_smc_lanes())
                            for name, lib in smc_libs.items() if name != "mixture_2d"
                            for mutation in ("MH", "MALA")},
                        resident_smc.CLOSURE_KERNEL: {
                            f"mixture_2d_{mutation}": resident_smc.kernel_resources(
                                smc_libs["mixture_2d"], mutation, resident_smc.CLOSURE_KERNEL)
                            for mutation in ("MH", "MALA")},
                        "nuts_depth_3": nuts_resources},
          "tuned_group_threads_and_cluster_blocks": {
              resident_hmc_dense.KERNEL: {str(cb): v for cb, v in dense_groups.items()},
              resident_walk_dense.KERNEL: walk_dense_groups, "nuts": nuts_groups},
          "card": card})

    # 2. fused kernel vs plain, on the same inputs on the card, at the main
    #    paths' chain counts (iris runs 32768 chains, XOR 131072)
    max_abs_err = 0.0
    timings, fused_event_times = {}, {}
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
            # CUDA events around one launch hold the host's launch path too
            event_ms = event_times(lambda: fused_mlp.fused_mlp_vg(
                lib, theta, *tensors, prior_const, temperature), reps=5)[0]
            plain_ms = device_ms(lambda: plain(theta, *tensors), 5)
            b_ms, b_by = bound_ms(vg_work(dims, bias, loss_kind == "ce", len(x), C), sm_count)
            timings[(name, C)] = (ms, plain_ms, b_ms, b_by)
            fused_event_times[(name, C)] = event_ms
            emit({"phase": "kernel_vs_plain", "case": name, "chains": C, "max_abs_err": err,
                  "rtol": 2e-5, "atol": atol, "ms": ms, "ms_is": "torch.profiler device time",
                  "event_ms": event_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                  "bound_by": b_by, "card": card})

    # 3. each whole-loop kernel vs its plain version, same seed and inputs, on
    #    the card. A tuned run is chaotic while early burn-in tries long
    #    steps: there, one-ulp changes of theta0 part many of the plain
    #    version's own chains within 20 burn-in iterations (the share that
    #    still agrees is reported for iris). So the 5-iteration burn-ins, which
    #    take the tuners through their hand-off, are held to
    #    RESIDENT_MIN_AGREEING, and the 20-iteration ones statistically: pooled
    #    means within 5 pooled standard errors, acceptance within 0.01.
    iris_tuner = HMCDATuner(l=0.15, e0=0.02)
    tuned_kw = dict(step=0.1, num_steps=10, tuner=iris_tuner, max_num_steps=64)
    dims_of = {id(m): extract_arch(m)[:3] for m in (iris_model, xor_model, xor2321_model)}

    def hmc_case(model, data, C, iters, burnin=0, extras=False, dense=False, **kw):
        module = resident_hmc_dense if dense else resident_hmc
        maker = (resident_hmc_dense.make_resident_hmc_dense if dense
                 else resident_hmc.make_resident_hmc)
        fn = maker(model, data.x, data.y, num_iters=iters, num_burnin_iters=burnin,
                   record_extras=extras, device=device, **kw)
        dims, bias, loss_kind = dims_of[id(model)]
        eval_work = dense_work(model, data.x, data.y, True) if dense else None

        def work(evaluations):
            return resident_work(dims, bias, loss_kind == "ce", len(data.x), C, evaluations,
                                 iters, iters - burnin, extras, eval_work)

        return module.KERNEL, module, fn, C, model.num_params, iters, burnin, work

    def walk_case(model, data, C, move, value, iters, burnin=0, extras=False, dense=False,
                  **kw):
        module = resident_walk_dense if dense else resident_walk
        maker = {(False, "mh"): resident_walk.make_resident_mh,
                 (False, "mala"): resident_walk.make_resident_mala,
                 (True, "mh"): resident_walk_dense.make_resident_mh_dense,
                 (True, "mala"): resident_walk_dense.make_resident_mala_dense}[(dense, move)]
        fn = maker(model, data.x, data.y, value, iters, burnin, record_extras=extras,
                   device=device, **kw)
        dims, bias, loss_kind = dims_of[id(model)]
        mala = move == "mala"
        if dense:
            eval_work, data_floats = dense_work(model, data.x, data.y, mala), 0
        else:
            eval_work = vg_work(dims, bias, loss_kind == "ce", len(data.x), 1, mala)[1:]
            data_floats = len(data.x) * (dims[0] + dims[-1] + 1) + 2 * model.num_params

        def work(_evaluations):
            return walk_work(model.num_params, C, iters, iters - burnin, extras, mala,
                             eval_work, data_floats)

        return module.KERNEL, module, fn, C, model.num_params, iters, burnin, work

    def gibbs_case(model, data, C, scales, iters, burnin=0, extras=False, dense=False,
                   node_subblock_size=None, **kw):
        module = resident_walk_dense if dense else resident_walk
        maker = (resident_walk_dense.make_resident_gibbs_dense if dense
                 else resident_walk.make_resident_gibbs)
        fn = maker(model, data.x, data.y, scales, node_subblock_size, num_iters=iters,
                   num_burnin_iters=burnin, record_extras=extras, device=device, **kw)
        dims, bias, loss_kind = extract_arch(model)[:3]
        sweep_units = [unit for _, _, unit in resident_walk.gibbs_sub_blocks(
            model, scales, node_subblock_size)]
        widths = [len(idx) for idx, _, _ in resident_walk.gibbs_sub_blocks(
            model, scales, node_subblock_size)]
        if dense:
            unit_work = gibbs_dense_work(model, data.x, data.y)
            init_work, data_floats = dense_work(model, data.x, data.y, False), 0
        else:
            unit_work = {(l, j): gibbs_unit_work(dims, bias, loss_kind == "ce", len(data.x), l)
                         for l in range(len(dims) - 1) for j in range(dims[l + 1])}
            init_work = vg_work(dims, bias, loss_kind == "ce", len(data.x), 1, False)[1:]
            data_floats = len(data.x) * (dims[0] + dims[-1] + 1) + 2 * model.num_params
        sweep = [(w, unit_work[u]) for w, u in zip(widths, sweep_units)]

        def work(_evaluations):
            return gibbs_work(model.num_params, C, iters, iters - burnin, extras, sweep,
                              init_work, data_floats)

        return module.GIBBS_KERNEL, module, fn, C, model.num_params, iters, burnin, work

    def tempering_case(model, data, C, sampler, step, iters, burnin=0, extras=False,
                       dense=False, between_step=CHECK_BETWEEN, rungs=LADDER_RUNGS, **kw):
        module = resident_walk_dense if dense else resident_walk
        maker = make_resident_tempering_dense if dense else make_resident_tempering
        fn = maker(model, data.x, data.y, rungs, step, sampler, between_step=between_step,
                   num_iters=iters, num_burnin_iters=burnin, record_extras=extras, device=device,
                   **kw)
        dims, bias, loss_kind = dims_of[id(model)]
        mala = sampler == "MALA"
        if dense:
            eval_work, data_floats = dense_work(model, data.x, data.y, mala), 0
        else:
            eval_work = vg_work(dims, bias, loss_kind == "ce", len(data.x), 1, mala)[1:]
            data_floats = len(data.x) * (dims[0] + dims[-1] + 1) + 2 * model.num_params

        def work(_evaluations):
            return tempering_work(model.num_params, C, iters, iters - burnin, extras, mala,
                                  eval_work, data_floats, rungs, between_step)

        return module.TEMPERING_KERNEL, module, fn, C, model.num_params, iters, burnin, work

    ladder_iters, ladder_burnin, G_ladders = 2048, 1024, 64

    def ladder(model, step):
        return PowerPosteriorSampler(model, num_chains=LADDER_RUNGS, sampler="MALA",
                                     sampler_kwargs={"step": step}, between_step=MAIN_BETWEEN,
                                     swap_scheme="even_odd")

    def ladder_plan(model, dataset, step):
        """The plan that dispatch gives a main tempering path; the kernel
        checks launch at its chain block, so at its launch layout."""
        plan, reason = resolve_tempering(ladder(model, step), (dataset.x, dataset.y),
                                         ladder_iters, ladder_burnin, platform="cuda")
        check(plan is not None, f"no tempering plan: {reason}")
        return plan

    iris_ladder_block = ladder_plan(iris_model, iris, 0.003).chain_block
    xor_ladder_block = ladder_plan(xor_model, xor, 0.05).chain_block
    xor_tuner = dict(step=0.1, num_steps=10, tuner=HMCDATuner(l=0.5))
    # tuned staged XOR HMC (backend="resident") takes JAX's group of 4096
    # chains, asked of the card: a cluster of the build with one thread a chain
    xor_staged_plan, reason = resolve_backend(
        HMC(xor_model, **xor_tuner),
        tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in (xor.x, xor.y)),
        131072, 10, 5, backend="resident")
    check(xor_staged_plan.chain_block == 4096, f"tuned staged XOR HMC plans groups of "
          f"{xor_staged_plan.chain_block}, not JAX's 4096 ({reason})")
    # a ladder of WALK_BLOCK rungs, the longest on the kernel: one thread a chain
    long_ladder = resident_walk.WALK_BLOCK
    resident_runs = [
        ("iris_untuned_extras", False, hmc_case(iris_model, iris, 32768, 20, extras=True,
                                                 step=0.02, num_steps=8, chain_block=256)),
        ("xor_untuned", False, hmc_case(xor_model, xor, 131072, 20, step=0.05, num_steps=10,
                                        chain_block=256)),
        ("iris_tuned_burnin_5", False, hmc_case(iris_model, iris, 32768, 10, 5,
                                                chain_block=256, **tuned_kw)),
        ("iris_tuned_burnin_20", True, hmc_case(iris_model, iris, 32768, 40, 20,
                                                chain_block=256, **tuned_kw)),
        # the maker's default tuning group, JAX's 2048 chains: a cluster
        ("iris_tuned_default_group_burnin_5", False, hmc_case(iris_model, iris, 32768, 10, 5,
                                                              **tuned_kw)),
        (f"xor_staged_tuned_group_{xor_staged_plan.chain_block}_burnin_5", False, hmc_case(
            xor_model, xor, 131072, 10, 5, chain_block=xor_staged_plan.chain_block,
            **xor_tuner)),
        ("xor_dense_untuned_extras", False, hmc_case(
            xor_model, xor, 131072, 20, extras=True, dense=True, step=0.05, num_steps=10,
            chain_block=8192)),
        ("xor_dense_tuned_burnin_5", False, hmc_case(
            xor_model, xor, 131072, 10, 5, dense=True, chain_block=8192, **xor_tuner)),
        ("xor_dense_per_chain_burnin_5", False, hmc_case(
            xor_model, xor, 131072, 10, 5, dense=True, chain_block=8192,
            tuner_mode="per_chain", **xor_tuner)),
        ("xor_dense_tuned_burnin_20", True, hmc_case(
            xor_model, xor, 131072, 40, 20, dense=True, chain_block=8192, **xor_tuner)),
        ("iris_mh_extras", False, walk_case(iris_model, iris, 32768, "mh", 0.1, 20,
                                            extras=True, chain_block=256)),
        ("iris_mala_extras", False, walk_case(iris_model, iris, 32768, "mala", 0.003, 20,
                                              extras=True, chain_block=256)),
        ("xor_mh_dense_extras", False, walk_case(xor_model, xor, 32768, "mh", 0.1, 20,
                                                 extras=True, dense=True)),
        ("xor_mlp2321_mala_dense_extras", False, walk_case(
            xor2321_model, xor, 32768, "mala", 0.01, 20, extras=True, dense=True)),
        ("xor_mh_dense_tuned_burnin_5", False, walk_case(
            xor_model, xor, 32768, "mh", 0.1, 10, 5, dense=True, tuner=HMCDATuner(d=0.234))),
        ("xor_mlp2321_mala_dense_tuned_burnin_5", False, walk_case(
            xor2321_model, xor, 32768, "mala", 0.01, 10, 5, dense=True, chain_block=4096,
            tuner=HMCDATuner(d=0.574))),
        ("xor_mlp2321_mala_dense_tuned_burnin_20", True, walk_case(
            xor2321_model, xor, 32768, "mala", 0.01, 40, 20, dense=True, chain_block=4096,
            tuner=HMCDATuner(d=0.574))),
        # JAX's smallest dense group, 1024 chains: a cluster of 16 lane blocks
        ("xor_mlp2321_mala_dense_tuned_group_1024_burnin_5", False, walk_case(
            xor2321_model, xor, 32768, "mala", 0.01, 10, 5, dense=True, chain_block=1024,
            tuner=HMCDATuner(d=0.574))),
        ("iris4323_gibbs_extras", False, gibbs_case(iris4323_model, iris, 32768, 0.1, 20,
                                                    extras=True, chain_block=4096)),
        ("iris4323_gibbs_split_units_extras", False, gibbs_case(
            iris4323_model, iris, 32768, 0.1, 20, extras=True, chain_block=4096,
            node_subblock_size=IRIS4323_SPLIT_UNITS)),
        ("xor_gibbs_staged_extras", False, gibbs_case(xor_model, xor, 32768, 0.5, 20,
                                                      extras=True, chain_block=4096)),
        ("xor_gibbs_dense_extras", False, gibbs_case(xor_model, xor, 32768, 0.5, 20,
                                                     extras=True, dense=True)),
        ("xor2321_gibbs_dense_subblocks", False, gibbs_case(
            xor2321_model, xor, 32768, 0.5, 20, extras=True, dense=True,
            node_subblock_size=xor2321_subblocks)),
        ("iris_tempering_mala_extras", False, tempering_case(
            iris_model, iris, 32768, "MALA", 0.003, 20, extras=True,
            chain_block=iris_ladder_block)),
        ("iris_tempering_mh_extras", False, tempering_case(
            iris_model, iris, 32768, "MetropolisHastings", 0.1, 20, extras=True,
            chain_block=iris_ladder_block)),
        (f"iris_tempering_mala_{long_ladder}_rungs_extras", False, tempering_case(
            iris_model, iris, 4096, "MALA", 0.003, 20, extras=True, rungs=long_ladder,
            chain_block=long_ladder)),
        ("xor_tempering_mala_dense_extras", False, tempering_case(
            xor_model, xor, 32768, "MALA", 0.05, 20, extras=True, dense=True,
            chain_block=xor_ladder_block)),
        ("xor_tempering_mh_dense_extras", False, tempering_case(
            xor_model, xor, 32768, "MetropolisHastings", 0.5, 20, extras=True, dense=True,
            chain_block=xor_ladder_block)),
    ]
    kernel_err = {}
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

    def lane_launch_of(fn, C):
        """The launch of a lane kernel's function for C chains (None for the
        kernels without lanes)."""
        launch = getattr(fn, "tempering_launch", lambda C: None)(C)
        if launch is not None:
            return launch
        for attr in ("gibbs_launch", "hmc_launch", "walk_launch"):
            if hasattr(fn, attr):
                return getattr(fn, attr)(C, sm_count)
        return None

    for name, chaotic, (kernel_name, module, fn, C, P, iters, burnin, work) in resident_runs:
        theta0s = torch.as_tensor(0.1 * rng.normal(size=(C, P)), dtype=torch.float32,
                                  device=device)
        out = fn(args.seed, theta0s)
        counted = getattr(module, "last_info", {}).get(kernel_name)
        counted = counted if counted and "evaluations" in counted else None
        counted = None if counted is None else int(counted["evaluations"])
        torch.cuda.synchronize()
        start = time.perf_counter()
        plain_out, plain_info = fn.plain(args.seed, theta0s)
        evaluations = int(plain_info["evaluations"])
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        agree, err = agreement(out, plain_out)
        share = agree.float().mean().item()
        limit = None if chaotic else (RESIDENT_LANE_MIN_AGREEING if name in LANE_CASES
                                      else RESIDENT_MIN_AGREEING)
        z = max_z(pooled_summary(out[0].transpose(0, 1)),
                  pooled_summary(plain_out[0].transpose(0, 1)))
        acc_diff = abs(out[2].mean().item() - plain_out[2].mean().item()) / (iters - burnin)
        plain_self_share = None
        if name == "iris_tuned_burnin_20":
            moved = torch.nextafter(theta0s, torch.full_like(theta0s, math.inf))
            plain_self_share = agreement(fn.plain(args.seed, moved)[0],
                                         plain_out)[0].float().mean().item()
        witness = None
        if kernel_name.endswith("_tempering") and share < 1.0:
            # the closest accept test of the disagreeing chains' ladders in
            # the plain version run in float64: a near-tie that float32
            # rounding flips, carried along its ladder by the swaps
            margins = []
            fn.plain(args.seed, theta0s, dtype=torch.float64, margins=margins)
            margins = torch.stack(margins)
            rungs = long_ladder if f"_{long_ladder}_rungs" in name else LADDER_RUNGS
            ladders = torch.unique(torch.nonzero(~agree).flatten().cpu() // rungs)
            witness = {"disagreeing_chains": int((~agree).sum()),
                       "their_ladders_closest_test_f64": margins.view(
                           margins.shape[0], -1, rungs)[:, ladders.to(margins.device)].min().item()}
            del margins
        ms, ms_runs = event_times(lambda: fn(args.seed, theta0s))
        b_ms, b_by = bound_ms(work(counted if counted is not None else evaluations), sm_count)
        resident_timings[name] = (ms, plain_ms, b_ms, b_by)
        emit({"phase": "resident_vs_plain", "kernel": kernel_name, "case": name,
              "chains": C, "iterations": iters, "burnin": burnin,
              "launch_shape": getattr(fn, "launch_shape", None),
              "lane_launch": lane_launch_of(fn, C),
              "evaluations_per_chain": evaluations / C,
              "kernel_evaluations_per_chain": None if counted is None else counted / C,
              "share_agreeing": share, "limit": limit, "atol": RESIDENT_ATOL,
              "rtol": RESIDENT_RTOL, "max_abs_err_agreeing": err,
              "plain_self_share_one_ulp": plain_self_share, "ladder_witness": witness,
              "max_abs_z_pooled_mean": z,
              "acceptance_difference": acc_diff, "ms": ms, "ms_runs": ms_runs,
              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "card": card})
        if chaotic:
            check(z <= 5.0 and acc_diff <= 0.01, f"{name}: pooled means {z} SEs apart, "
                  f"acceptance {acc_diff} apart")
        else:
            check(share >= limit, f"{name}: only {share:.4f} of chains agree with the plain "
                  f"version (limit {limit})")
            kernel_err[kernel_name] = max(kernel_err.get(kernel_name, 0.0), err)
        if counted is not None and "tuned" not in name and "per_chain" not in name:
            check(counted == evaluations, f"{name}: the kernel counted {counted} evaluations, "
                  f"the plain version {evaluations}")
        del out, plain_out
        torch.cuda.empty_cache()

    # the equal-temperature pin on the card: one temperature on every rung
    # makes the swap log-rate exactly 0, so every post-burn-in round in which
    # a chain is the lower member of a pair is an accepted swap (but where its
    # swap uniform is exactly 1, a 2^-23 chance a draw, which no log-rate
    # below 0 accepts)
    C, iters, burnin = 32768, 20, 4
    fn = make_resident_tempering_dense(xor_model, xor.x, xor.y, LADDER_RUNGS, 0.05, "MALA",
                                       temperatures=np.ones(LADDER_RUNGS),
                                       between_step=CHECK_BETWEEN, num_iters=iters,
                                       num_burnin_iters=burnin, device=device)
    theta0s = torch.as_tensor(0.1 * rng.normal(size=(C, xor_model.num_params)),
                              dtype=torch.float32, device=device)
    swaps = fn(args.seed, theta0s)[2][:, 1].cpu()
    chains = torch.arange(C)
    rung = chains % LADDER_RUNGS
    eligible = torch.zeros(C)
    for t in (t for t in range(burnin, iters) if t % CHECK_BETWEEN == 0):
        lower = (rung % 2 == (t // CHECK_BETWEEN) % 2) & (rung < LADDER_RUNGS - 1)
        u_swap = kernel_prng.tempering_draws(args.seed, chains, t, xor_model.num_params)[2]
        eligible += (lower & (u_swap < 1.0)).float()
    mismatched = int((swaps != eligible).sum())
    emit({"phase": "tempering_equal_temperature_pin", "kernel": resident_walk_dense.TEMPERING_KERNEL,
          "chains": C, "iterations": iters, "burnin": burnin, "between_step": CHECK_BETWEEN,
          "swaps_accepted": float(swaps.sum()), "swaps_eligible": float(eligible.sum()),
          "chains_mismatched": mismatched, "card": card})
    check(mismatched == 0, f"equal-temperature pin: {mismatched} chains accepted other than "
          "every eligible swap")

    # the NUTS kernels against their plain versions: NUTS_CHECK_CHAINS prior
    # draws x NUTS_CHECK_ITERS iterations at depth NUTS_DEPTH, at the main
    # paths' steps and chain blocks (the plans dispatch gives them on the
    # card), untuned, tuned, with a metric and with extras; phase 15 adds the
    # build of each main path at its plan (the probed depth, step and metric).
    # A chain agrees when its every output is within NUTS_ATOL + NUTS_RTOL
    # |plain|, and its final step (the step of its tuning group) within
    # NUTS_RTOL of the plain version's. A tuned run of the staged kernel is
    # chaotic: its burn-in steps grow tenfold (m = log(10 step)), and a
    # multinomial draw that rounding flips moves its group's mean accept_stat
    # and so the step of every chain in the group (the plain version's own
    # one-ulp self-agreement is reported). Such a run is held to
    # NUTS_MIN_AGREEING_CHAOTIC of its chains and NUTS_MIN_STEPS_AGREEING of
    # its steps, where a fault in the tuner parts every group; every other
    # run to NUTS_MIN_AGREEING of both.
    nuts_data = {name: tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                             for a in (ds.x, ds.y)) for name, ds in (("xor", xor), ("iris", iris))}

    def nuts_plan(model, data_name, C, backend="auto", **kw):
        kernel = NUTS(model, step=0.1, max_depth=NUTS_DEPTH, fixed_budget=True, **kw)
        plan, reason = resolve_backend(kernel, nuts_data[data_name], C, 2048, 1024,
                                       backend=backend)
        check(plan is not None, f"no NUTS plan: {reason}")
        return plan

    nuts_blocks = {name: nuts_plan(model, name, C, tuner=HMCDATuner(d=0.8)).chain_block
                   for name, model, C in (("xor", xor_model, 32768), ("iris", iris_model, 16384))}
    # staged NUTS on XOR keeps JAX's tuning group of 4096 chains, which takes
    # the build with one thread a chain (a cluster of lane blocks holds 256)
    nuts_blocks["xor_staged"] = nuts_plan(xor_model, "xor", NUTS_CHECK_CHAINS, backend="resident",
                                          tuner=HMCDATuner(d=0.8)).chain_block
    check(nuts_blocks["xor_staged"] == 4096,
          f"tuned staged XOR NUTS plans groups of {nuts_blocks['xor_staged']}, not JAX's 4096")

    def nuts_eval(model, dataset, dense):
        """(eval_work, data_floats) of a NUTS kernel's evaluation."""
        if dense:
            return dense_work(model, dataset.x, dataset.y, True), 0
        dims, bias, loss_kind = dims_of[id(model)]
        return (vg_work(dims, bias, loss_kind == "ce", len(dataset.x), 1)[1:],
                len(dataset.x) * (dims[0] + dims[-1] + 1) + 2 * model.num_params)

    def nuts_vs_plain(name, fn, module, theta0s, iters, burnin, chaotic):
        """Hold a NUTS kernel function of ``iters`` iterations, ``burnin`` of
        them burn-in, against its plain version on ``theta0s`` (checked; the
        error of a run that is not chaotic goes into the kernels line): a
        record of the agreement."""
        kept = iters - burnin
        out = fn(args.seed, theta0s)
        steps = module.last_info[module.KERNEL]["step"]
        torch.cuda.synchronize()
        start = time.perf_counter()
        plain_out, plain_info = fn.plain(args.seed, theta0s)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        agree, err = None, 0.0
        for got, want, chain_dim in zip(out, plain_out, (1, 0, 0, 0, 1, 1)):
            ok, e = chain_agreement(got, want, chain_dim, NUTS_ATOL, NUTS_RTOL)
            agree = ok if agree is None else agree & ok
            err = max(err, e)
        share = agree.float().mean().item()
        plain_steps = plain_info["step"].double()
        step_diff = (steps.double() - plain_steps).abs() / plain_steps.abs()
        step_share = (step_diff <= NUTS_RTOL).double().mean().item()
        z = max_z(pooled_summary(out[0].transpose(0, 1)),
                  pooled_summary(plain_out[0].transpose(0, 1)))
        stat_diff = abs(out[2].mean().item() - plain_out[2].mean().item()) / kept
        plain_self_share = None
        if chaotic:
            moved = torch.nextafter(theta0s, torch.full_like(theta0s, math.inf))
            for got, want, chain_dim in zip(fn.plain(args.seed, moved)[0], plain_out, (1, 0, 0, 0)):
                ok = chain_agreement(got, want, chain_dim, NUTS_ATOL, NUTS_RTOL)[0]
                plain_self_share = ok if plain_self_share is None else plain_self_share & ok
            plain_self_share = plain_self_share.float().mean().item()
        limits = ((NUTS_MIN_AGREEING_CHAOTIC, NUTS_MIN_STEPS_AGREEING) if chaotic
                  else (NUTS_MIN_AGREEING, NUTS_MIN_AGREEING))
        record = {
            "chains": theta0s.shape[0], "iterations": iters, "burnin": burnin,
            "chaotic": chaotic, "share_agreeing": share, "limit": limits[0],
            "atol": NUTS_ATOL, "rtol": NUTS_RTOL, "max_abs_err_agreeing": err,
            "share_steps_agreeing": step_share, "steps_limit": limits[1],
            "max_rel_step_diff": step_diff.max().item(),
            "plain_self_share_one_ulp": plain_self_share, "max_abs_z_pooled_mean": z,
            "accept_stat": out[2].mean().item() / kept,
            "plain_accept_stat": plain_out[2].mean().item() / kept,
            "divergence_rate": out[3].mean().item() / kept,
            "plain_divergence_rate": plain_out[3].mean().item() / kept, "plain_ms": plain_ms}
        check(share >= limits[0] and step_share >= limits[1],
              f"{name}: {share:.5f} of chains (limit {limits[0]}) and {step_share:.5f} of final "
              f"steps (limit {limits[1]}) agree with the plain version")
        if chaotic:
            check(z <= 5.0 and stat_diff <= NUTS_ACCEPT_TOL, f"{name}: pooled means {z} SEs "
                  f"apart, accept_stat {stat_diff} apart")
        else:
            kernel_err[module.KERNEL] = max(kernel_err.get(module.KERNEL, 0.0), err)
        del out, plain_out
        return record

    nuts_runs = []
    for data_name, model, dataset, dense, step in (("iris", iris_model, iris, False, 0.02),
                                                   ("xor", xor_model, xor, True, 0.1)):
        cb = nuts_blocks[data_name]
        label = f"{data_name}_nuts" + ("_dense" if dense else "")
        nuts_runs += [
            (f"{label}_untuned", model, dataset, dense, step, dict(chain_block=cb)),
            (f"{label}_tuned_burnin_{NUTS_CHECK_BURNIN}", model, dataset, dense, step,
             dict(chain_block=cb, tuner=HMCDATuner(d=0.8), num_burnin_iters=NUTS_CHECK_BURNIN)),
            (f"{label}_metric", model, dataset, dense, step,
             dict(chain_block=cb, inv_mass=nuts_metric[data_name])),
            (f"{label}_extras", model, dataset, dense, step,
             dict(chain_block=cb, record_extras=True, num_burnin_iters=1))]
    nuts_runs.append((f"xor_nuts_staged_tuned_group_{nuts_blocks['xor_staged']}", xor_model, xor,
                      False, 0.1, dict(chain_block=nuts_blocks["xor_staged"],
                                       tuner=HMCDATuner(d=0.8),
                                       num_burnin_iters=NUTS_CHECK_BURNIN)))
    nuts_timings = {}
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for name, model, dataset, dense, step, kw in nuts_runs:
        module = resident_nuts_dense if dense else resident_nuts
        maker = (resident_nuts_dense.make_resident_nuts_dense if dense
                 else resident_nuts.make_resident_nuts)
        fn = maker(model, dataset.x, dataset.y, step, NUTS_DEPTH, NUTS_CHECK_ITERS, device=device,
                   **kw)
        C, iters, burnin = NUTS_CHECK_CHAINS, NUTS_CHECK_ITERS, kw.get("num_burnin_iters", 0)
        kept, extras = iters - burnin, kw.get("record_extras", False)
        theta0s = model.prior.sample(gen, (C,))
        held = nuts_vs_plain(name, fn, module, theta0s, iters, burnin,
                             chaotic=not dense and "tuner" in kw)
        ms, ms_runs = event_times(lambda: fn(args.seed, theta0s))
        eval_work, data_floats = nuts_eval(model, dataset, dense)
        b_ms, b_by = bound_ms(nuts_work(model.num_params, C, iters, kept, extras, NUTS_DEPTH,
                                        eval_work, data_floats), sm_count)
        nuts_timings[name] = (ms, held["plain_ms"], b_ms, b_by)
        emit({"phase": "resident_vs_plain", "kernel": module.KERNEL, "case": name,
              "depth": NUTS_DEPTH, "step": step, "chain_block": kw["chain_block"],
              "launch_shape": fn.launch_shape,
              "lane_launch": fn.nuts_launch(C, sm_count) if hasattr(fn, "nuts_launch") else None,
              "evaluations_per_chain": 1 + iters * (2 ** NUTS_DEPTH - 1), **held, "ms": ms,
              "ms_runs": ms_runs, "bound_ms": b_ms, "bound_by": b_by, "card": card})
        torch.cuda.empty_cache()

    # the SMC mutation kernels against their plain versions: one pass of
    # SMC_STEPS moves of SMC_PARTICLES prior (or base) draws, at the chain
    # block that dispatch gives each main path (the kernel's launch does not
    # depend on it), at two temperatures
    smc_timings = {}
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def smc_vs_plain(kernel, name, step, fn, theta0s, own_ll, work, chain_block):
        """Hold ``fn`` (a mutation maker's function) against ``fn.plain`` at
        beta 0.3 and 1.0; ``own_ll(final [N, P]) -> [N]`` is the untempered
        log-likelihood the kernel's pot must equal."""
        for beta in (0.3, 1.0):
            out = fn(args.seed, beta, theta0s)
            torch.cuda.synchronize()
            start = time.perf_counter()
            plain_out, info = fn.plain(args.seed, beta, theta0s)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - start)
            agree, err = None, 0.0
            for got, want in zip(out, plain_out):
                ok, e = chain_agreement(got, want, 0)
                agree = ok if agree is None else agree & ok
                err = max(err, e)
            share = agree.float().mean().item()
            ll = own_ll(out[0])
            pot_err = (out[1] - ll).abs().max().item()
            pot_ok = bool(((out[1] - ll).abs() <= 1e-3 + 1e-4 * ll.abs()).all())
            ms, ms_runs = event_times(lambda: fn(args.seed, beta, theta0s))
            b_ms, b_by = bound_ms(work, sm_count)
            smc_timings[(name, beta)] = (ms, plain_ms, b_ms, b_by)
            emit({"phase": "resident_vs_plain", "kernel": kernel,
                  "case": f"{name}_step_{step}_beta_{beta}", "particles": SMC_PARTICLES,
                  "steps": SMC_STEPS, "chain_block": chain_block,
                  "launch_threads": fn.launch_threads,
                  "launch": fn.smc_launch(SMC_PARTICLES, sm_count),
                  "evaluations_per_particle": info["evaluations"] / SMC_PARTICLES,
                  "share_agreeing": share, "limit": RESIDENT_MIN_AGREEING,
                  "atol": RESIDENT_ATOL, "rtol": RESIDENT_RTOL, "max_abs_err_agreeing": err,
                  "acceptance": out[2].mean().item() / SMC_STEPS,
                  "plain_acceptance": plain_out[2].mean().item() / SMC_STEPS,
                  "max_abs_pot_vs_own_split_ll": pot_err, "ms": ms, "ms_runs": ms_runs,
                  "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "card": card})
            check(share >= RESIDENT_MIN_AGREEING, f"SMC {name}, beta {beta}: only {share:.4f} of "
                  f"particles agree with the plain version")
            check(pot_ok, f"SMC {name}, beta {beta}: pot is not the split log-likelihood of the "
                  f"final particles (max abs diff {pot_err})")
            kernel_err[kernel] = max(kernel_err.get(kernel, 0.0), err)
            del out, plain_out
        torch.cuda.empty_cache()

    smc_cases = [("xor_mala", xor_model, xor, "MALA", 0.05),
                 ("iris_mala", iris_model, iris, "MALA", 0.003),
                 ("iris_mh", iris_model, iris, "MH", 0.01)]
    for name, model, data, mutation, step in smc_cases:
        plan, reason = resolve_smc(SMCSampler(model, SMC_PARTICLES, mutation=mutation,
                                              mutation_step=step),
                                   (data.x, data.y), platform="cuda")
        check(plan is not None and plan.backend == "resident", f"{name}: no SMC plan: {reason}")
        fn = resident_smc.make_resident_smc_mutation(model, data.x, data.y, step, SMC_STEPS,
                                                      chain_block=plan.chain_block,
                                                      mutation=mutation, device=device)
        arrays = prepare_data(model, data.x, data.y)
        split = make_vg(model, *arrays[:6], 1.0, with_grad=False, split=True)
        tensors = [torch.as_tensor(a, device=device) for a in arrays[:5]]
        dims, bias, loss_kind = extract_arch(model)[:3]
        eval_work = vg_work(dims, bias, loss_kind == "ce", len(data.x), 1, mutation == "MALA")[1:]
        data_floats = len(data.x) * (dims[0] + dims[-1] + 1) + 2 * model.num_params
        smc_vs_plain(resident_smc.KERNEL, name, step, fn,
                     model.prior.sample(gen, (SMC_PARTICLES,)),
                     lambda final: split(final.T.contiguous(), *tensors)[0][0],
                     smc_work(model.num_params, SMC_PARTICLES, SMC_STEPS, mutation == "MALA",
                              eval_work, data_floats), plan.chain_block)
    mixture_sampler = SMCSampler(mixture, SMC_PARTICLES, init_sampler=mixture_init,
                                 base_log_pdf=mixture_base)
    plan, reason = resolve_smc(mixture_sampler, empty, platform="cuda")
    check(plan is not None and plan.backend == "resident", f"mixture: no SMC plan: {reason}")
    for mutation in ("MALA", "MH"):
        fn = resident_smc.make_resident_smc_mutation(
            mixture, *empty, 0.05, SMC_STEPS, chain_block=plan.chain_block, mutation=mutation,
            base_log_pdf=mixture_base, device=device)
        smc_vs_plain(resident_smc.CLOSURE_KERNEL, f"mixture_{mutation.lower()}", 0.05, fn,
                     mixture_init(gen, SMC_PARTICLES),
                     lambda final: mixture_log_pdf(final, None, None) - mixture_base(final),
                     smc_work(2, SMC_PARTICLES, SMC_STEPS, mutation == "MALA", fn.eval_work, 0),
                     plan.chain_block)

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
    xor_data = (xor.x, xor.y)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    whole_loop = (resident_hmc, resident_hmc_dense, resident_walk, resident_walk_dense,
                  resident_smc, resident_nuts, resident_nuts_dense)

    def reset_counts():
        for module in whole_loop:
            for name in module.launch_counts:
                module.launch_counts[name] = 0
        torch.cuda.synchronize()

    def read_counts():
        return {name: n for module in whole_loop for name, n in module.launch_counts.items()}

    def iris_chains(seed_gen):
        kernel = HMC(iris_model, tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64)
        return sample_chains(kernel, seed_gen, iris_theta0s, iris_data, iters, burnin,
                             backend="auto")

    main_launches = {name: {} for name in read_counts()}
    reset_counts()
    start = time.perf_counter()
    chains = iris_chains(gen)
    torch.cuda.synchronize()
    iris_wall = time.perf_counter() - start
    counts = read_counts()
    main_launches[resident_hmc.KERNEL]["iris_hmc"] = counts[resident_hmc.KERNEL]
    check(counts == {**dict.fromkeys(counts, 0), resident_hmc.KERNEL: 1},
          f"iris sample_chains made the launches {counts}, not one resident_hmc")
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
          "acceptance_post_burnin": acc, "kernel_launches": counts,
          "max_abs_z_pooled_mean_vs_fused": z, "limit": 5.0,
          "multi_rhat_first_64": rhat, "multi_ess_mean_first_64": float(np.mean(ess)),
          "card": card})
    check(abs(acc - 0.65) <= 0.15, f"iris sample_chains: acceptance {acc} outside 0.65 +- 0.15")
    check(z <= 5.0, f"iris sample_chains: pooled means differ from FusedHMC's by {z} SEs")
    check(math.isfinite(rhat) and all(math.isfinite(e) for e in ess),
          f"iris: multi_rhat {rhat} or multi_ess {ess[:4]}... not finite")
    del chains, samples, head
    torch.cuda.empty_cache()

    # 8. main path, XOR (the bench.py problem), through sample_chains: auto
    #    takes the dense kernel, and the resident kernel is asked for
    xor_summaries = {}
    for backend, module in (("auto", resident_hmc_dense), ("resident", resident_hmc)):
        xor_hmc = HMC(xor_model, step=0.05, num_steps=10)
        plan, _ = resolve_backend(xor_hmc, xor_data, xor_theta0s.shape[0], xor_iters,
                                  platform="cuda", backend=backend)
        reset_counts()
        start = time.perf_counter()
        chains = sample_chains(xor_hmc, gen, xor_theta0s, xor_data, xor_iters, backend=backend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = read_counts()
        main_launches[module.KERNEL][f"xor_hmc_{backend}"] = counts[module.KERNEL]
        check(counts == {**dict.fromkeys(counts, 0), module.KERNEL: 1},
              f"XOR sample_chains(backend={backend!r}) made the launches {counts}, "
              f"not one {module.KERNEL}")
        check(bool(torch.isfinite(chains.get_samples()).all()), "XOR sample_chains: non-finite")
        acc = chains.tensor("accepted").float().mean().item()
        xor_summaries[backend] = pooled_summary(chains.get_samples())
        emit({"phase": "main_sample_chains_xor", "backend": backend,
              "plan": [plan.backend, plan.chain_block], "chains": xor_theta0s.shape[0],
              "iterations": xor_iters, "seconds": wall,
              "samples_per_s": xor_theta0s.shape[0] * xor_iters / wall, "acceptance": acc,
              "kernel_launches": counts, "card": card})
        check(0.2 < acc <= 1.0, f"XOR sample_chains: acceptance {acc} outside (0.2, 1]")
        del chains
        torch.cuda.empty_cache()
    C_generic = 4096
    reset_counts()
    start = time.perf_counter()
    generic = sample_chains(HMC(xor_model, step=0.05, num_steps=10), gen,
                            xor_theta0s[:C_generic], xor_data, xor_iters,
                            record_keys=("sample", "accepted"), backend="scan")
    torch.cuda.synchronize()
    generic_wall = time.perf_counter() - start
    check(not any(read_counts().values()), "the XOR generic path launched a whole-loop kernel")
    z = max_z(xor_summaries["auto"], xor_summaries["resident"])
    z_generic = max_z(xor_summaries["auto"], pooled_summary(generic.get_samples()))
    emit({"phase": "main_xor_dense_vs_resident_and_generic", "max_abs_z_pooled_mean": z,
          "max_abs_z_pooled_mean_vs_generic": z_generic, "generic_chains": C_generic,
          "generic_seconds": generic_wall,
          "generic_samples_per_s": C_generic * xor_iters / generic_wall, "limit": 5.0,
          "card": card})
    check(z <= 5.0, f"XOR: dense and resident runs' pooled means differ by {z} SEs")
    check(z_generic <= 5.0, f"XOR: dense and generic runs' pooled means differ by "
          f"{z_generic} SEs")
    del generic
    torch.cuda.empty_cache()

    # 9. the generic path (batched autograd) on the same problem, fewer chains
    reset_counts()
    start = time.perf_counter()
    chains = sample_chains(HMC(iris_model, tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64),
                           gen, iris_theta0s[:C_generic], iris_data, iters, burnin,
                           record_keys=("sample", "accepted"), backend="scan")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    check(not any(read_counts().values()), "the generic path launched a whole-loop kernel")
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

    # 10. where the time goes on the sample_chains iris path, and the bound
    #     of that launch from the kernel's evaluation counter
    torch.cuda.synchronize()
    start = time.perf_counter()
    chains, by_kernel = profiled(lambda: iris_chains(gen))
    wall = time.perf_counter() - start
    busy = sum(by_kernel.values()) / 1e3
    kernel_ms = sum(ms for name, ms in by_kernel.items() if "resident_hmc" in name)
    iris_evaluations = int(resident_hmc.last_info[resident_hmc.KERNEL]["evaluations"])
    dims, bias, loss_kind = dims_of[id(iris_model)]
    iris_b_ms, iris_b_by = bound_ms(resident_work(
        dims, bias, loss_kind == "ce", len(iris.x), iris_theta0s.shape[0], iris_evaluations,
        iters, iters - burnin, False), sm_count)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    # the share is taken of phase 7's unprofiled host-clock time of the same call
    emit({"phase": "profile_sample_chains_iris", "chains": chains.num_chains(),
          "iterations": iters, "seconds": iris_wall, "seconds_profiled": wall,
          "device_busy_seconds": busy, "device_busy_share": busy / iris_wall,
          "resident_hmc_ms": kernel_ms,
          "evaluations_per_chain": iris_evaluations / iris_theta0s.shape[0],
          "resident_hmc_bound_ms": iris_b_ms, "resident_hmc_bound_by": iris_b_by,
          "device_kernels_seen": len(by_kernel),
          "device_ms_by_kernel": {name[:60]: ms for name, ms in top}, "card": card})
    del chains

    # 11. the walk main paths through sample_chains(backend="auto"): BASELINE.md
    #     configs 1 and 2 on XOR (dense), iris MALA and MH (resident), each
    #     against the generic path of the same configuration at 4096 chains
    C_walk, walk_iters, walk_burnin = 32768, 2048, 1024
    walk_theta0s = {P: torch.as_tensor(0.1 * rng.normal(size=(C_walk, P)), dtype=torch.float32,
                                       device=device)
                    for P in (xor_model.num_params, xor2321_model.num_params,
                              iris_model.num_params)}
    walk_paths = [
        ("config1_mh_xor", lambda: MetropolisHastings(xor_model, scale=0.1), xor_model,
         xor_data, "dense", resident_walk_dense),
        ("config2_mala_xor_mlp2321", lambda: MALA(xor2321_model, step=0.01), xor2321_model,
         xor_data, "dense", resident_walk_dense),
        ("iris_mala", lambda: MALA(iris_model, step=0.003), iris_model, iris_data, "resident",
         resident_walk),
        ("iris_mh", lambda: MetropolisHastings(iris_model, scale=0.1), iris_model, iris_data,
         "resident", resident_walk),
    ]
    walk_walls = {}
    for name, sampler, model, data, want, module in walk_paths:
        theta0s = walk_theta0s[model.num_params]
        plan, reason = resolve_backend(sampler(), data, C_walk, walk_iters, walk_burnin,
                                       platform="cuda")
        check(plan is not None and plan.backend == want,
              f"{name}: dispatch chose {plan and plan.backend} ({reason}), not {want}")
        reset_counts()
        kernel = sampler()
        start = time.perf_counter()
        chains = sample_chains(kernel, gen, theta0s, data, walk_iters, walk_burnin,
                               backend="auto")
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        walk_walls[name] = wall
        ((_, walk_fn),) = kernel._backend_cache.items()
        walk_launch = lane_launch_of(walk_fn, C_walk)
        del kernel, walk_fn
        counts = read_counts()
        main_launches[module.KERNEL][name] = counts[module.KERNEL]
        check(counts == {**dict.fromkeys(counts, 0), module.KERNEL: 1},
              f"{name}: sample_chains made the launches {counts}, not one {module.KERNEL}")
        samples = chains.get_samples()
        check(samples.shape == (C_walk, walk_iters - walk_burnin, model.num_params),
              f"{name}: samples of shape {tuple(samples.shape)}")
        check(bool(torch.isfinite(samples).all()), f"{name}: non-finite samples")
        acc = chains.tensor("accepted").float().mean().item()
        walk_summary = pooled_summary(samples)
        head = ChainLists.from_arrays({k: chains.tensor(k)[:64].cpu() for k in chains.keys()})
        rhat = head.multi_rhat()[0]
        ess = head.multi_ess()
        del chains, samples, head
        torch.cuda.empty_cache()
        reset_counts()
        start = time.perf_counter()
        generic = sample_chains(sampler(), gen, theta0s[:C_generic], data, walk_iters,
                                walk_burnin, record_keys=("sample", "accepted"), backend="scan")
        torch.cuda.synchronize()
        generic_wall = time.perf_counter() - start
        check(not any(read_counts().values()), f"{name}: the generic path launched a kernel")
        generic_acc = generic.tensor("accepted").float().mean().item()
        z = max_z(walk_summary, pooled_summary(generic.get_samples()))
        emit({"phase": "main_sample_chains_walk", "case": name, "plan": [plan.backend,
                                                                          plan.chain_block],
              "chains": C_walk, "iterations": walk_iters, "burnin": walk_burnin,
              "seconds": wall, "samples_per_s": C_walk * walk_iters / wall,
              "acceptance_post_burnin": acc, "kernel_launches": counts, "launch": walk_launch,
              "acceptance_reference": WALK_ACCEPTANCE.get(name),
              "generic_chains": C_generic, "generic_seconds": generic_wall,
              "generic_samples_per_s": C_generic * walk_iters / generic_wall,
              "generic_acceptance_post_burnin": generic_acc,
              "max_abs_z_pooled_mean_vs_generic": z, "limit": 5.0,
              "multi_rhat_first_64": rhat, "multi_ess_mean_first_64": float(np.mean(ess)),
              "card": card})
        check(z <= 5.0, f"{name}: pooled means differ from the generic path's by {z} SEs")
        check(0.0 < acc <= 1.0, f"{name}: acceptance {acc}")
        if name in WALK_ACCEPTANCE:
            check(abs(acc - WALK_ACCEPTANCE[name]) <= WALK_ACCEPTANCE_TOL,
                  f"{name}: acceptance {acc}, the one-thread build's {WALK_ACCEPTANCE[name]}")
        check(math.isfinite(rhat) and all(math.isfinite(e) for e in ess),
              f"{name}: multi_rhat {rhat} or multi_ess {ess[:4]}... not finite")
        del generic
        torch.cuda.empty_cache()

    # 12. the Gibbs main paths through sample_chains(backend="auto"): BASELINE.md
    #     config 4 on iris (staged) and XOR MLP(2,2,1) (dense), each against the
    #     generic path of the same configuration at C_generic chains, and the
    #     kernel's time beside its bound (one more launch of the same function)
    gibbs_paths = [
        ("config4_gibbs_iris_mlp4323", 0.1, iris4323_model, iris, iris_data, "resident",
         resident_walk),
        ("xor_gibbs_mlp221", 0.5, xor_model, xor, xor_data, "dense", resident_walk_dense),
    ]
    gibbs_main = {}
    for name, scales, model, dataset, data, want, module in gibbs_paths:
        theta0s = torch.as_tensor(0.1 * rng.normal(size=(C_walk, model.num_params)),
                                  dtype=torch.float32, device=device)
        plan, reason = resolve_backend(Gibbs(model, scales=scales), data, C_walk, walk_iters,
                                       walk_burnin, platform="cuda")
        check(plan is not None and plan.backend == want,
              f"{name}: dispatch chose {plan and plan.backend} ({reason}), not {want}")
        reset_counts()
        start = time.perf_counter()
        chains = sample_chains(Gibbs(model, scales=scales), gen, theta0s, data, walk_iters,
                               walk_burnin, backend="auto")
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = read_counts()
        main_launches[module.GIBBS_KERNEL][name] = counts[module.GIBBS_KERNEL]
        check(counts == {**dict.fromkeys(counts, 0), module.GIBBS_KERNEL: 1},
              f"{name}: sample_chains made the launches {counts}, not one "
              f"{module.GIBBS_KERNEL}")
        samples = chains.get_samples()
        kept = walk_iters - walk_burnin
        check(samples.shape == (C_walk, kept, model.num_params),
              f"{name}: samples of shape {tuple(samples.shape)}")
        check(bool(torch.isfinite(samples).all()), f"{name}: non-finite samples")
        kernel_rates = (module.last_info[module.GIBBS_KERNEL]["accept_counts"].double()
                        / kept).mean(0).cpu()
        gibbs_summary = pooled_summary(samples)
        head = ChainLists.from_arrays({k: chains.tensor(k)[:64].cpu() for k in chains.keys()})
        rhat = head.multi_rhat()[0]
        ess = head.multi_ess()
        del chains, samples, head
        torch.cuda.empty_cache()
        _, _, fn, _, _, _, _, work = gibbs_case(model, dataset, C_walk, scales, walk_iters,
                                                walk_burnin, dense=want == "dense",
                                                chain_block=plan.chain_block)
        gibbs_ms, gibbs_runs = event_times(lambda: fn(args.seed, theta0s))
        b_ms, b_by = bound_ms(work(None), sm_count)
        # the record's share of the kernel: the same run keeping one iteration
        one_kept = gibbs_case(model, dataset, C_walk, scales, walk_iters, walk_iters - 1,
                              dense=want == "dense", chain_block=plan.chain_block)[2]
        one_kept_ms = event_times(lambda: one_kept(args.seed, theta0s))[0]
        del one_kept
        lane = fn.gibbs_launch(C_walk, sm_count) if hasattr(fn, "gibbs_launch") else None
        gibbs_main[module.GIBBS_KERNEL] = {"case": name, "ms": gibbs_ms, "ms_runs": gibbs_runs,
                                           "bound_ms": b_ms, "bound_by": b_by,
                                           "ms_keeping_one_iteration": one_kept_ms,
                                           "lane_launch": lane}
        torch.cuda.empty_cache()
        reset_counts()
        start = time.perf_counter()
        generic = sample_chains(Gibbs(model, scales=scales), gen, theta0s[:C_generic], data,
                                walk_iters, walk_burnin, record_keys=("sample", "accepted"),
                                backend="scan")
        torch.cuda.synchronize()
        generic_wall = time.perf_counter() - start
        check(not any(read_counts().values()), f"{name}: the generic path launched a kernel")
        flags = generic.tensor("accepted")  # [C, kept, B]
        generic_rates = ChainList.from_arrays(
            {"accepted": flags.reshape(-1, flags.shape[-1]).cpu()}).block_acceptance_rate()
        rate_diff = (kernel_rates - generic_rates).abs().max().item()
        z = max_z(gibbs_summary, pooled_summary(generic.get_samples()))
        emit({"phase": "main_sample_chains_gibbs", "case": name,
              "plan": [plan.backend, plan.chain_block], "chains": C_walk,
              "iterations": walk_iters, "burnin": walk_burnin, "seconds": wall,
              "samples_per_s": C_walk * walk_iters / wall, "kernel_launches": counts,
              "kernel_ms": gibbs_ms, "kernel_bound_ms": b_ms, "kernel_bound_by": b_by,
              "kernel_ms_keeping_one_iteration": one_kept_ms,
              "lane_launch": lane, "block_acceptance": kernel_rates.tolist(),
              "generic_block_acceptance": generic_rates.tolist(),
              "max_abs_block_acceptance_difference": rate_diff,
              "block_acceptance_limit": GIBBS_BLOCK_ACCEPTANCE_TOL,
              "generic_chains": C_generic, "generic_seconds": generic_wall,
              "generic_samples_per_s": C_generic * walk_iters / generic_wall,
              "max_abs_z_pooled_mean_vs_generic": z, "limit": 5.0,
              "multi_rhat_first_64": rhat, "multi_ess_mean_first_64": float(np.mean(ess)),
              "card": card})
        check(z <= 5.0, f"{name}: pooled means differ from the generic path's by {z} SEs")
        check(rate_diff <= GIBBS_BLOCK_ACCEPTANCE_TOL,
              f"{name}: per-block acceptance {rate_diff} from the generic path's")
        check(math.isfinite(rhat) and all(math.isfinite(e) for e in ess),
              f"{name}: multi_rhat {rhat} or multi_ess {ess[:4]}... not finite")
        del generic, flags
        torch.cuda.empty_cache()

    # 13. the tempering main paths through PowerPosteriorSampler.run(backend=
    #     "auto", all_ladders=True): XOR (dense) and iris (staged), each
    #     against the generic ladder (sample_population over G_ladders
    #     independent ladders in one state); then each maker at C_walk chains,
    #     its kernel timed beside its bound
    L = LADDER_RUNGS
    ladder_kept = ladder_iters - ladder_burnin
    ladder_paths = [
        ("tempering_mala_xor_mlp221", 0.05, xor_model, xor, xor_data, "dense",
         resident_walk_dense, 8192),
        ("tempering_mala_iris_mlp433", 0.003, iris_model, iris, iris_data, "resident",
         resident_walk, 4096),
    ]
    tempering_main = {}

    def per_ladder_z(a, b):
        """|mean a - mean b| over the pooled standard error, per rung, of
        per-ladder statistics a [G_a, L] and b [G_b, L]."""
        se = torch.sqrt(a.var(0) / a.shape[0] + b.var(0) / b.shape[0])
        diff = (a.mean(0) - b.mean(0)).abs()
        # a rung that accepts every proposal in every ladder of both runs has
        # no spread and no difference
        return torch.where(diff == 0, 0.0, diff / se)

    for name, step, model, dataset, data, want, module, at_size_block in ladder_paths:
        P = model.num_params
        theta0 = torch.as_tensor(0.1 * rng.normal(size=(L, P)), dtype=torch.float32,
                                 device=device)
        plan = ladder_plan(model, dataset, step)
        check(plan.backend == want, f"{name}: dispatch chose {plan.backend}, not {want}")
        reset_counts()
        start = time.perf_counter()
        chains = ladder(model, step).run(gen, theta0, data, ladder_iters, ladder_burnin,
                                         backend="auto", all_ladders=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = read_counts()
        main_launches[module.TEMPERING_KERNEL][name] = counts[module.TEMPERING_KERNEL]
        check(counts == {**dict.fromkeys(counts, 0), module.TEMPERING_KERNEL: 1},
              f"{name}: run made the launches {counts}, not one {module.TEMPERING_KERNEL}")
        samples = chains.get_samples()
        C = plan.chain_block
        check(samples.shape == (C, ladder_kept, P),
              f"{name}: samples of shape {tuple(samples.shape)}")
        check(bool(torch.isfinite(samples).all()), f"{name}: non-finite samples")
        acc = module.last_info[module.TEMPERING_KERNEL]["accept_counts"].double().cpu()
        within = acc[:, 0].reshape(-1, L) / ladder_kept  # [ladders, L]
        rounds = swap_rounds(L, ladder_iters, MAIN_BETWEEN, first=ladder_burnin)
        swap_rates = [(acc[:, 1].reshape(-1, L)[:, r].mean() / rounds[r]).item()
                      for r in range(L - 1)]
        kernel_cold = pooled_summary(samples[L - 1::L])
        del chains, samples
        torch.cuda.empty_cache()
        reset_counts()
        start = time.perf_counter()
        generic = sample_population(ladder(model, step), gen, theta0.repeat(G_ladders, 1),
                                    data, ladder_iters, ladder_burnin,
                                    record_keys=("sample", "accepted"))
        torch.cuda.synchronize()
        generic_wall = time.perf_counter() - start
        check(not any(read_counts().values()), f"{name}: the generic ladder launched a kernel")
        generic_samples = generic.get_samples()
        check(bool(torch.isfinite(generic_samples).all()), f"{name}: generic non-finite")
        generic_within = generic.tensor("accepted").double().cpu().reshape(
            G_ladders, L, -1).mean(2)
        z = max_z(kernel_cold, pooled_summary(generic_samples[L - 1::L]))
        # the cold rung is held to the generic ladder; the hot ones are
        # reported: on XOR the generic model's BCE on probabilities is -inf
        # where a point saturates on the wrong side (models/losses.py), the
        # kernel's on logits finite, and at temperatures near 0 that rejects
        # proposals that the kernel accepts
        z_within = per_ladder_z(within, generic_within)
        del generic, generic_samples
        torch.cuda.empty_cache()
        timed = {}
        for label, C_timed, block in (("at_size", C_walk, at_size_block),
                                      ("entry_point_block", C, C)):
            _, _, fn, C_timed, _, _, _, work = tempering_case(
                model, dataset, C_timed, "MALA", step, ladder_iters, ladder_burnin,
                dense=want == "dense", between_step=MAIN_BETWEEN, chain_block=block)
            timed_theta0s = theta0.repeat(C_timed // L, 1)
            ms, ms_runs = event_times(lambda: fn(args.seed, timed_theta0s))
            b_ms, b_by = bound_ms(work(None), sm_count)
            timed[label] = {
                "case": name, "chains": C_timed, "chain_block": block, "ladders": C_timed // L,
                "ms": ms, "ms_runs": ms_runs, "bound_ms": b_ms, "bound_by": b_by,
                "samples_per_s": C_timed * ladder_iters / (ms / 1e3),
                "launch": lane_launch_of(fn, C_timed),
                "launch_threads": getattr(fn, "launch_shape", None)}
            del fn
        tempering_main[module.TEMPERING_KERNEL] = dict(
            timed["at_size"], entry_point_block=timed["entry_point_block"])
        emit({"phase": "main_tempering", "case": name,
              "plan": [plan.backend, plan.chain_block], "rungs": L,
              "temperatures": plan.kwargs["temperatures"].tolist(), "between_step": MAIN_BETWEEN,
              "chains": C, "ladders": C // L, "iterations": ladder_iters,
              "burnin": ladder_burnin, "seconds": wall, "samples_per_s": C * ladder_iters / wall,
              "kernel_launches": counts, "within_acceptance_per_rung": within.mean(0).tolist(),
              "swap_acceptance_per_pair": swap_rates,
              "generic_ladders": G_ladders, "generic_seconds": generic_wall,
              "generic_within_acceptance_per_rung": generic_within.mean(0).tolist(),
              "max_abs_z_cold_rung_pooled_mean_vs_generic": z,
              "z_within_acceptance_vs_generic_per_rung": z_within.tolist(), "limit": 5.0,
              "at_size": tempering_main[module.TEMPERING_KERNEL], "card": card})
        check(z <= 5.0, f"{name}: the cold rung's pooled means differ from the generic "
              f"ladder's by {z} SEs")
        check(z_within[-1] <= 5.0, f"{name}: the cold rung's acceptance differs from the "
              f"generic ladder's by {z_within[-1]} SEs")
        torch.cuda.empty_cache()

    # 14. the SMC main paths through SMCSampler.run(backend="auto"), each run
    #     over SMC_SEEDS seeds, config 5 and iris beside the generic path
    #     (backend="scan") over as many; the standard error of a path's
    #     estimate is the spread of its seeds' estimates
    betas5 = [(i / 20) ** 4 for i in range(21)]

    def smc_sampler(model, betas, mutation, step, N=SMC_PARTICLES, **kw):
        return SMCSampler(model, N, betas=betas, mutation=mutation, mutation_step=step,
                          num_mutation_steps=SMC_STEPS, **kw)

    def weighted(state):
        """(weighted mean [P], its ESS standard error [P]) of a final cloud."""
        w = torch.softmax(state.log_weights.double(), 0)
        p = state.particles.double()
        mean = w @ p
        return mean, torch.sqrt((w @ (p - mean) ** 2) * (w * w).sum())

    def smc_seeds(sampler, data, backend, first_seed):
        """SMC_SEEDS runs of ``sampler``: per run (state summary, diagnostics,
        wall, launch counts)."""
        runs = []
        for s in range(SMC_SEEDS):
            g = torch.Generator(device=device).manual_seed(first_seed + s)
            reset_counts()
            start = time.perf_counter()
            state, diags = sampler.run(g, data, backend=backend)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            check(state.particles.shape == (sampler.num_particles, sampler.model.num_params)
                  and bool(torch.isfinite(state.particles).all()),
                  f"SMC {backend}: particles of shape {tuple(state.particles.shape)} or not "
                  "finite")
            check(not state.log_lik.any(), "SMC: log_lik is not zeros")
            share = float(torch.softmax(state.log_weights.double(), 0)[
                state.particles[:, 0] > 0].sum())
            runs.append({"summary": weighted(state), "diags": diags, "wall": wall,
                         "counts": read_counts(), "share_theta0_positive": share})
        return runs

    def seed_stats(runs):
        means = torch.stack([r["summary"][0] for r in runs])
        evidence = np.array([r["diags"]["log_evidence"] for r in runs])
        return means, evidence

    smc_paths = [
        ("config5_xor_mala", smc_sampler(xor_model, betas5, "MALA", 0.05),
         smc_sampler(xor_model, betas5, "MALA", 0.05), xor_data, resident_smc.KERNEL),
        ("xor_adaptive_mala", smc_sampler(xor_model, "adaptive", "MALA", 0.1), None, xor_data,
         resident_smc.KERNEL),
        ("iris_mala", smc_sampler(iris_model, betas5, "MALA", 0.003),
         smc_sampler(iris_model, betas5, "MALA", 0.003), iris_data, resident_smc.KERNEL),
        ("iris_mh", smc_sampler(iris_model, betas5, "MH", 0.01),
         smc_sampler(iris_model, betas5, "MH", 0.01, N=4096), iris_data, resident_smc.KERNEL),
        ("mixture_closure", smc_sampler(
            mixture, "adaptive", "MALA", 0.05, init_sampler=mixture_init,
            base_log_pdf=mixture_base, max_stages=60), None, empty,
         resident_smc.CLOSURE_KERNEL),
    ]
    smc_main, smc_evidence = {}, {}
    for index, (name, sampler, generic_sampler, data, kernel) in enumerate(smc_paths):
        plan, reason = resolve_smc(sampler, data, platform="cuda")
        check(plan is not None and plan.backend == "resident",
              f"{name}: dispatch chose {plan and plan.backend} ({reason}), not resident")
        runs = smc_seeds(sampler, data, "auto", 1000 * index)
        for r in runs:
            stages = len(r["diags"]["beta"])
            expected = {**dict.fromkeys(r["counts"], 0), kernel: stages}
            check(r["counts"] == expected,
                  f"{name}: a run of {stages} stages made the launches {r['counts']}")
        main_launches[kernel][name] = sum(r["counts"][kernel] for r in runs)
        means, evidence = seed_stats(runs)
        smc_evidence[name] = evidence
        walls = sorted(r["wall"] for r in runs)
        wall = walls[len(walls) // 2]
        stages = [len(r["diags"]["beta"]) for r in runs]
        g = torch.Generator(device=device).manual_seed(1000 * index + SMC_SEEDS)
        (_, profile_diags), by_kernel = profiled(lambda: sampler.run(g, data, backend="auto"))
        busy = sum(by_kernel.values()) / 1e3
        kernel_device_ms = sum(ms for k, ms in by_kernel.items() if kernel in k)
        record = {
            "phase": "main_smc", "case": name, "plan": [plan.backend, plan.chain_block],
            "particles": sampler.num_particles, "mutation": sampler.mutation,
            "mutation_step": sampler.mutation_step, "steps": SMC_STEPS, "seeds": SMC_SEEDS,
            "stages": stages, "seconds": wall, "seconds_min_max": [walls[0], walls[-1]],
            "particle_stage_mutations_per_s":
                sampler.num_particles * float(np.median(stages)) * SMC_STEPS / wall,
            "mutation_acceptance": float(np.mean([float(r["diags"]["mutation_acceptance"].mean())
                                                  for r in runs])),
            "resamples": float(np.mean([int(r["diags"]["resampled"].sum()) for r in runs])),
            "log_evidence_mean": float(evidence.mean()),
            "log_evidence_spread": float(evidence.std(ddof=1)),
            "kernel_launches_first_run": runs[0]["counts"],
            "device_busy_share": busy / wall,
            "kernel_device_ms_per_run": kernel_device_ms,
            "kernel_device_ms_per_launch": kernel_device_ms / max(1, len(profile_diags["beta"])),
            "card": card}
        if kernel == resident_smc.KERNEL:  # the launch of this path's build
            rows = iris_rows if sampler.model is iris_model else xor_rows
            record["launch"] = resident_smc.smc_launch(
                resident_smc.load_kernel(sampler.model, resident_smc.smc_lanes(rows)),
                sampler.mutation, sampler.num_particles, rows, sm_count)
        if name == "xor_adaptive_mala":
            for r in runs:
                betas = r["diags"]["beta"].numpy()
                check(betas[-1] == 1.0 and bool(np.all(np.diff(betas) > 0)),
                      f"{name}: betas {betas} do not rise to 1")
            diff = abs(evidence.mean() - smc_evidence["config5_xor_mala"].mean())
            record.update(betas_first_run=runs[0]["diags"]["beta"].tolist(),
                          log_evidence_vs_config5=diff, limit=0.1)
            check(diff <= 0.1, f"{name}: log-evidence {diff} from config 5's")
        if name == "mixture_closure":
            shares = np.array([r["share_theta0_positive"] for r in runs])
            record.update(share_theta0_positive=float(shares.mean()),
                          share_theta0_positive_runs=shares.tolist(), share_limit=0.05,
                          log_evidence_limit=0.1, true_log_evidence=0.0)
            check(abs(evidence.mean()) <= 0.1, f"{name}: log-evidence {evidence.mean()} not 0")
            check(abs(shares.mean() - 0.5) <= 0.05, f"{name}: share {shares.mean()} not 0.5")
        if generic_sampler is not None:
            generic_runs = smc_seeds(generic_sampler, data, "scan", 1000 * index + 500)
            check(not any(v for r in generic_runs for v in r["counts"].values()),
                  f"{name}: the generic path launched a kernel")
            gmeans, gevidence = seed_stats(generic_runs)
            se = torch.sqrt(means.var(0) / SMC_SEEDS + gmeans.var(0) / SMC_SEEDS)
            z = ((means.mean(0) - gmeans.mean(0)).abs() / se).max().item()
            (m1, s1), (m2, s2) = runs[0]["summary"], generic_runs[0]["summary"]
            z_ess = ((m1 - m2).abs() / torch.sqrt(s1 ** 2 + s2 ** 2)).max().item()
            spread = float(gevidence.std(ddof=1))
            tol = max(0.1, 5.0 * spread)
            # past 0.5 nats the tolerance would pass almost any evidence: the
            # difference is then a reading only
            evidence_checked = tol <= 0.5
            diff = abs(evidence.mean() - gevidence.mean())
            gwalls = sorted(r["wall"] for r in generic_runs)
            record.update(
                generic_particles=generic_sampler.num_particles,
                generic_seconds=gwalls[len(gwalls) // 2],
                generic_mutation_acceptance=float(np.mean(
                    [float(r["diags"]["mutation_acceptance"].mean()) for r in generic_runs])),
                generic_log_evidence_mean=float(gevidence.mean()),
                generic_log_evidence_spread=spread,
                max_abs_z_weighted_mean_vs_generic=z, limit=5.0,
                z_ess_standard_errors_first_seeds=z_ess,
                log_evidence_difference=diff,
                log_evidence_tolerance=tol if evidence_checked else None)
            check(z <= 5.0, f"{name}: weighted means {z} standard errors from the generic path")
            check(not evidence_checked or diff <= tol, f"{name}: log-evidence {diff} from the "
                  f"generic path's (tolerance {tol})")
        smc_main[name] = record
        emit(record)
        torch.cuda.empty_cache()

    # 15. main paths, NUTS, sample_chains(backend="auto"): fixed-budget NUTS
    #     at depth 3 with HMCDATuner(d=0.8) on XOR (dense) and iris (staged),
    #     and max_depth="auto" on XOR without and with mass_adapt (the probe
    #     inside sample_chains, then the dense kernel at the probed depth and
    #     step), each beside the generic path of the same kernel object at
    #     NUTS_GENERIC_CHAINS chains. The generic path takes 12-50 ms an
    #     iteration on the card, so the comparisons run NUTS_GENERIC_ITERS on
    #     both sides (the kernel again at that length); the timed run is the
    #     whole 2048.
    nuts_iters, nuts_burnin = 2048, 1024

    def frozen_nuts(model, step, depth, inv_mass):
        """Untuned fixed-budget NUTS at a step, depth and frozen metric on
        either path: dispatch forwards ``_frozen_inv_mass`` (the probe's
        bridge) to the kernel as ``inv_mass``, and the generic path starts
        from it."""
        k = NUTS(model, step=step, max_depth=depth, fixed_budget=True)
        if inv_mass is not None:
            k._frozen_inv_mass = np.asarray(inv_mass)
            im = torch.as_tensor(k._frozen_inv_mass, dtype=torch.float32, device=device)
            init = k.init
            k.init = lambda thetas, x, y, generator=None: init(thetas, x, y, generator)._replace(
                inv_mass=im.expand_as(thetas).contiguous())
        return k

    nuts_paths = [
        ("xor_fixed_depth_3", xor_model, xor, "xor", 32768,
         dict(step=0.1, max_depth=NUTS_DEPTH, fixed_budget=True), resident_nuts_dense),
        ("iris_fixed_depth_3", iris_model, iris, "iris", 16384,
         dict(step=0.02, max_depth=NUTS_DEPTH, fixed_budget=True), resident_nuts),
        ("xor_auto", xor_model, xor, "xor", 32768, dict(max_depth="auto"), resident_nuts_dense),
        ("xor_auto_mass_adapt", xor_model, xor, "xor", 32768,
         dict(max_depth="auto", mass_adapt=True), resident_nuts_dense)]
    nuts_main = {}
    for name, model, dataset, data_name, C, kw, module in nuts_paths:
        data = nuts_data[data_name]
        kernel = NUTS(model, tuner=HMCDATuner(d=0.8), **kw)
        probe = {"seconds": None}

        def timed_resolve(*a, resolve=kernel.resolve_auto_budget, probe=probe, **k):
            """The first call's wall (the probe; later calls find its data)."""
            start = time.perf_counter()
            resolve(*a, **k)
            torch.cuda.synchronize()
            if probe["seconds"] is None:
                probe["seconds"] = time.perf_counter() - start

        kernel.resolve_auto_budget = timed_resolve
        theta0s = torch.as_tensor(0.1 * rng.normal(size=(C, model.num_params)),
                                  dtype=torch.float32, device=device)
        gen = torch.Generator(device=device).manual_seed(args.seed + 20)
        reset_counts()
        start = time.perf_counter()
        rec = sample_chains(kernel, gen, theta0s, data, nuts_iters, nuts_burnin,
                            return_arrays=True)
        torch.cuda.synchronize()
        first_wall = time.perf_counter() - start
        counts = read_counts()
        for kernel_name, n in counts.items():
            if n:
                main_launches[kernel_name][f"nuts_{name}"] = n
        check(counts[module.KERNEL] == 1 and sum(counts.values()) == 1,
              f"NUTS {name}: launches {counts}, expected one of {module.KERNEL}")
        kept = nuts_iters - nuts_burnin
        info = module.last_info[module.KERNEL]
        accept_stat = info["accept_sums"].mean().item() / kept
        divergence_rate = info["divergent_sums"].sum().item() / (C * kept)
        check(bool(torch.isfinite(rec["sample"]).all()), f"NUTS {name}: non-finite samples")
        plan, _ = resolve_backend(kernel, data, C, nuts_iters, nuts_burnin)
        depth = plan.kwargs["max_depth"]
        # the probe again, from the same seed: the same depth, step and metric
        reproduced = None
        if kernel.auto_depth:
            again = NUTS(model, tuner=HMCDATuner(d=0.8), **kw)
            again.resolve_auto_budget(data, torch.Generator(device=device).manual_seed(
                args.seed + 20))
            reproduced = (again.max_depth == depth and again.step0 == plan.kwargs["step"]
                          and (not kernel.mass_adapt or np.array_equal(
                              again._frozen_inv_mass, kernel._frozen_inv_mass)))
        # this path's build against its plain version, at the plan's depth,
        # step, metric and tuner over a check's length
        check_fn = plan.maker(model, dataset.x, dataset.y, device=device,
                              **dict(plan.kwargs, num_iters=NUTS_CHECK_ITERS,
                                     num_burnin_iters=NUTS_CHECK_BURNIN))
        held = nuts_vs_plain(f"NUTS {name}", check_fn, module, theta0s[:NUTS_CHECK_CHAINS],
                             NUTS_CHECK_ITERS, NUTS_CHECK_BURNIN,
                             chaotic=module is resident_nuts and kernel.tuner is not None)
        del check_fn
        start = time.perf_counter()
        rec = sample_chains(kernel, gen, theta0s, data, nuts_iters, nuts_burnin,
                            return_arrays=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        reset_counts()
        _, by_kernel = profiled(lambda: sample_chains(kernel, gen, theta0s, data, nuts_iters,
                                                      nuts_burnin, return_arrays=True))
        profiled_counts = read_counts()
        fn = plan.maker(model, dataset.x, dataset.y, device=device, **plan.kwargs)
        k_ms, k_runs = event_times(lambda: fn(args.seed, theta0s))
        _, by_kernel_direct = profiled(lambda: fn(args.seed, theta0s))
        # the traced busy share where the trace holds the kernel; where it
        # does not (an open question, PERF.md), an estimate: the traced
        # kernels' time and the CUDA-event time of a launch of the same build
        profiler_saw_kernel = any(f"{module.KERNEL}_kernel" in n for n in by_kernel)
        profiler_saw_direct_launch = any(f"{module.KERNEL}_kernel" in n for n in by_kernel_direct)
        traced = sum(by_kernel.values()) / 1e3
        estimate = traced + (0.0 if profiler_saw_kernel else k_ms / 1e3)
        eval_work, data_floats = nuts_eval(model, dataset, plan.backend == "dense")
        b_ms, b_by = bound_ms(nuts_work(model.num_params, C, nuts_iters, kept, False, depth,
                                        eval_work, data_floats), sm_count)
        # the comparisons, both sides at the cut length: the tuned path
        # against the generic path of the same kernel object (pooled means;
        # the accept_stat of each is a reading, as the kernel tunes one step
        # a group on the group mean and the generic path each chain's own,
        # which lands higher: JAX's benchmarks/DENSE_NUTS_RESULTS.json has
        # 0.797 against 0.828 on iris), and untuned fixed-budget NUTS at the
        # plan's step, depth and metric on both paths (pooled means and
        # accept_stat)
        comparison = {"iterations": NUTS_GENERIC_ITERS, "burnin": NUTS_GENERIC_BURNIN,
                      "kernel_chains": C, "generic_chains": NUTS_GENERIC_CHAINS, "limit": 5.0,
                      "accept_stat_limit": NUTS_ACCEPT_TOL}
        frozen = frozen_nuts(model, plan.kwargs["step"], depth, plan.kwargs.get("inv_mass"))
        for label, k in (("tuned", kernel), ("frozen", frozen)):
            start = time.perf_counter()
            grec = sample_chains(k, gen, theta0s[:NUTS_GENERIC_CHAINS], data, NUTS_GENERIC_ITERS,
                                 NUTS_GENERIC_BURNIN, backend="scan", return_arrays=True,
                                 record_keys=("sample", "accept_stat", "divergent"))
            torch.cuda.synchronize()
            generic_wall = time.perf_counter() - start
            crec = sample_chains(k, gen, theta0s, data, NUTS_GENERIC_ITERS, NUTS_GENERIC_BURNIN,
                                 return_arrays=True)
            cut_kept = NUTS_GENERIC_ITERS - NUTS_GENERIC_BURNIN
            cut_accept = module.last_info[module.KERNEL]["accept_sums"].mean().item() / cut_kept
            generic_accept = grec["accept_stat"].float().mean().item()
            z = max_z(pooled_summary(crec["sample"]), pooled_summary(grec["sample"]))
            comparison[label] = {
                "generic_seconds": generic_wall, "kernel_accept_stat": cut_accept,
                "generic_accept_stat": generic_accept,
                "generic_divergence_rate": grec["divergent"].float().mean().item(),
                "max_abs_z_pooled_mean": z}
            del grec, crec
        record = {
            "phase": "main_nuts", "path": name, "kernel": module.KERNEL,
            "plan": {"backend": plan.backend, "maker": plan.maker.__name__,
                     "chain_block": plan.chain_block, "depth": depth,
                     "step": plan.kwargs["step"], "launch_shape": fn.launch_shape,
                     "lane_launch": (fn.nuts_launch(C, sm_count) if hasattr(fn, "nuts_launch")
                                     else None),
                     "inv_mass": None if "inv_mass" not in plan.kwargs
                     else [float(v) for v in plan.kwargs["inv_mass"]]},
            "probed": kernel.auto_depth, "probe_seconds": probe["seconds"],
            "chains": C, "iterations": nuts_iters, "burnin": nuts_burnin,
            "probe_reproduced": reproduced,
            "first_call_seconds": first_wall, "seconds": wall,
            "samples_per_s": C * nuts_iters / wall,
            "profiled_call_launches": profiled_counts,
            "profiler_saw_kernel": profiler_saw_kernel,
            "profiler_saw_direct_launch": profiler_saw_direct_launch,
            "device_busy_share": traced / wall if profiler_saw_kernel else None,
            "device_busy_share_event_estimate": estimate / wall,
            "device_ms_by_kernel": {n[:60]: ms for n, ms in by_kernel.items()},
            "kernel_ms": k_ms, "kernel_ms_runs": k_runs,
            "bound_ms": b_ms, "bound_by": b_by,
            "accept_stat": accept_stat, "accept_stat_target": 0.8,
            "divergence_rate": divergence_rate, "comparison": comparison,
            "vs_plain": held, "card": card}
        nuts_main[name] = record
        emit(record)
        check(profiled_counts[module.KERNEL] == 1 and sum(profiled_counts.values()) == 1,
              f"NUTS {name}: the profiled call launched {profiled_counts}, expected one of "
              f"{module.KERNEL}")
        check(reproduced in (None, True), f"NUTS {name}: the probe gave another depth, step "
              "or metric from the same seed")
        check(abs(accept_stat - 0.8) <= NUTS_ACCEPT_TOL,
              f"NUTS {name}: post-burn-in accept_stat {accept_stat}, the tuner's target 0.8")
        for label, c in ((label, comparison[label]) for label in ("tuned", "frozen")):
            check(c["max_abs_z_pooled_mean"] <= 5.0, f"NUTS {name} ({label}): pooled means "
                  f"{c['max_abs_z_pooled_mean']} SEs from the generic path")
        c = comparison["frozen"]
        check(abs(c["kernel_accept_stat"] - c["generic_accept_stat"]) <= NUTS_ACCEPT_TOL,
              f"NUTS {name}: accept_stat {c['kernel_accept_stat']} against the generic path's "
              f"{c['generic_accept_stat']} at one step")
        del rec
        torch.cuda.empty_cache()

    # 16. kernels: fused_mlp_vg timed at the iris main path's shape; each
    #     whole-loop kernel at a main path's shape (XOR HMC, untuned, for the
    #     two HMC kernels: the leapfrog count is fixed; iris MALA for
    #     resident_walk; config 1 for resident_walk_dense), against its plain
    #     version on the same inputs

    def timed_at_main(fn, theta0s, work):
        start = time.perf_counter()
        info = fn.plain(args.seed, theta0s)[1]
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        ms = event_times(lambda: fn(args.seed, theta0s))[0]
        return ms, plain_ms, *bound_ms(work(int(info["evaluations"])), sm_count)

    C = xor_theta0s.shape[0]
    xor_dims = dims_of[id(xor_model)]

    def xor_hmc_work(dense):
        eval_work = dense_work(xor_model, xor.x, xor.y, True) if dense else None

        def work(evaluations):
            check(evaluations == C * (1 + 10 * xor_iters), "XOR: unexpected evaluation count")
            return resident_work(xor_dims[0], xor_dims[1], False, len(xor.x), C, evaluations,
                                 xor_iters, xor_iters, False, eval_work)
        return work

    main_timings = {
        resident_hmc.KERNEL: timed_at_main(
            resident_hmc.make_resident_hmc(xor_model, xor.x, xor.y, 0.05, 10, xor_iters,
                                           chain_block=1024, device=device),
            xor_theta0s, xor_hmc_work(False)),
        resident_hmc_dense.KERNEL: timed_at_main(
            resident_hmc_dense.make_resident_hmc_dense(xor_model, xor.x, xor.y, 0.05, 10,
                                                       xor_iters, device=device),
            xor_theta0s, xor_hmc_work(True)),
    }
    walk_timed = {resident_walk.KERNEL: ("iris MALA step 0.003", walk_case(
                      iris_model, iris, C_walk, "mala", 0.003, walk_iters, walk_burnin,
                      chain_block=4096)),
                  resident_walk_dense.KERNEL: ("config 1, MH scale 0.1 on XOR", walk_case(
                      xor_model, xor, C_walk, "mh", 0.1, walk_iters, walk_burnin, dense=True))}
    for kernel_name, (_, (_, _, fn, _, P, _, _, work)) in walk_timed.items():
        main_timings[kernel_name] = timed_at_main(fn, walk_theta0s[P], work)
        torch.cuda.empty_cache()
    # the other walk main paths' kernels, timed alone (no plain version)
    other_walks = {}
    for kernel_name, label, (_, _, fn, _, P, _, _, work) in (
            (resident_walk.KERNEL, "iris MH scale 0.1", walk_case(
                iris_model, iris, C_walk, "mh", 0.1, walk_iters, walk_burnin,
                chain_block=4096)),
            (resident_walk_dense.KERNEL, "config 2, MALA step 0.01 on XOR MLP(2,3,2,1)",
             walk_case(xor2321_model, xor, C_walk, "mala", 0.01, walk_iters, walk_burnin,
                       dense=True))):
        ms_ = event_times(lambda: fn(args.seed, walk_theta0s[P]))[0]
        b_ms_, b_by_ = bound_ms(work(None), sm_count)
        other_walks[kernel_name] = {"timed_at": label, "launch": lane_launch_of(fn, C_walk),
                                    "ms": ms_, "bound_ms": b_ms_,
                                    "bound_by": b_by_}
        torch.cuda.empty_cache()

    def whole_loop_entry(module, source, replaces, timed_at):
        ms_, plain_ms_, b_ms_, b_by_ = main_timings[module.KERNEL]
        return {"name": module.KERNEL, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(main_launches[module.KERNEL].values()),
                "launches_by_path": main_launches[module.KERNEL],
                "max_abs_err": kernel_err[module.KERNEL], "ms": ms_, "plain_ms": plain_ms_,
                "bound_ms": b_ms_, "bound_by": b_by_, "library_ms": None, "timed_at": timed_at}

    xor_timed_at = "XOR MLP(2,2,1), step 0.05, 10 leapfrog steps, 131072 chains x 256"
    ms, plain_ms, b_ms, b_by = timings[("iris_mlp433_ce", 32768)]
    fused_event_ms = fused_event_times[("iris_mlp433_ce", 32768)]
    resident_entry = whole_loop_entry(resident_hmc, RESIDENT_SOURCE, RESIDENT_REPLACES,
                                      xor_timed_at)
    resident_entry["tuned_iris"] = dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"),
                                            resident_timings["iris_tuned_burnin_20"]))
    resident_entry["main_iris_run"] = {"ms": kernel_ms, "bound_ms": iris_b_ms,
                                       "bound_by": iris_b_by,
                                       "evaluations_per_chain":
                                           iris_evaluations / iris_theta0s.shape[0],
                                       "lanes": resident_libs[0].resident_hmc_lanes()}
    # the lanes a chain of each build (XOR, timed above, on one thread a chain)
    resident_entry["lanes"] = {"iris": resident_libs[0].resident_hmc_lanes(),
                               "xor": resident_libs[1].resident_hmc_lanes()}
    walk_at = f"{C_walk} chains x {walk_iters} iterations, {walk_burnin} burn-in"

    def gibbs_entry(module, source, replaces, case):
        ms_, plain_ms_, b_ms_, b_by_ = resident_timings[case]
        return {"name": module.GIBBS_KERNEL, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(main_launches[module.GIBBS_KERNEL].values()),
                "launches_by_path": main_launches[module.GIBBS_KERNEL],
                "max_abs_err": kernel_err[module.GIBBS_KERNEL], "ms": ms_, "plain_ms": plain_ms_,
                "bound_ms": b_ms_, "bound_by": b_by_, "library_ms": None,
                "timed_at": f"{case}: 32768 chains x 20 iterations, extras",
                "main_run": dict(gibbs_main[module.GIBBS_KERNEL], timed_at=walk_at)}

    def tempering_entry(module, source, replaces, case):
        ms_, plain_ms_, b_ms_, b_by_ = resident_timings[case]
        return {"name": module.TEMPERING_KERNEL, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(main_launches[module.TEMPERING_KERNEL].values()),
                "launches_by_path": main_launches[module.TEMPERING_KERNEL],
                "max_abs_err": kernel_err[module.TEMPERING_KERNEL], "ms": ms_,
                "plain_ms": plain_ms_, "bound_ms": b_ms_, "bound_by": b_by_, "library_ms": None,
                "timed_at": f"{case}: 32768 chains x 20 iterations, ladders of {L}, extras",
                "main_run": dict(tempering_main[module.TEMPERING_KERNEL],
                                 timed_at=f"{ladder_iters} iterations, {ladder_burnin} "
                                          "burn-in")}

    # the SMC mutation kernels at their main paths' shapes (config 5's; the
    # mixture's, MALA), the other cases as measured against the plain version
    def smc_entry(kernel, source, replaces, case, timed_at):
        ms_, plain_ms_, b_ms_, b_by_ = smc_timings[(case, 0.3)]
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(main_launches[kernel].values()),
                "launches_by_path": main_launches[kernel], "max_abs_err": kernel_err[kernel],
                "ms": ms_, "plain_ms": plain_ms_, "bound_ms": b_ms_, "bound_by": b_by_,
                "library_ms": None,
                "timed_at": f"{timed_at}, {SMC_PARTICLES} particles x {SMC_STEPS} steps, beta 0.3",
                "cases": {f"{n}_beta_{b}": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), v))
                          for (n, b), v in smc_timings.items()
                          if n.startswith("mixture") == (kernel == resident_smc.CLOSURE_KERNEL)},
                "main_run_device_ms_per_launch": {
                    n: r["kernel_device_ms_per_launch"] for n, r in smc_main.items()
                    if n in main_launches[kernel]}}

    smc_entries = [
        dict(smc_entry(resident_smc.KERNEL, SMC_SOURCE, SMC_REPLACES, "xor_mala",
                       "config 5's shape: XOR MLP(2,2,1), MALA step 0.05"),
             lanes={name: lib.resident_smc_lanes() for name, lib in smc_libs.items()
                    if name != "mixture_2d"}),
        smc_entry(resident_smc.CLOSURE_KERNEL, SMC_CLOSURE_SOURCE, SMC_CLOSURE_REPLACES,
                  "mixture_mala", "the 2-d mixture's main path: MALA step 0.05")]

    def nuts_entry(module, source, replaces, case, main_paths):
        ms_, plain_ms_, b_ms_, b_by_ = nuts_timings[case]
        return {"name": module.KERNEL, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(main_launches[module.KERNEL].values()),
                "launches_by_path": main_launches[module.KERNEL],
                "max_abs_err": kernel_err[module.KERNEL], "ms": ms_, "plain_ms": plain_ms_,
                "bound_ms": b_ms_, "bound_by": b_by_, "library_ms": None,
                "timed_at": f"{case}: {NUTS_CHECK_CHAINS} chains x {NUTS_CHECK_ITERS} "
                            f"iterations, depth {NUTS_DEPTH}",
                "main_runs": {n: {k: nuts_main[n][k] for k in ("chains", "iterations", "kernel_ms",
                                                              "bound_ms", "bound_by")}
                              | {"depth": nuts_main[n]["plan"]["depth"],
                                 "share_agreeing_with_plain": nuts_main[n]["vs_plain"][
                                     "share_agreeing"]}
                              for n in main_paths}}

    nuts_entries = [
        nuts_entry(resident_nuts, NUTS_SOURCE, NUTS_REPLACES, "iris_nuts_untuned",
                   ["iris_fixed_depth_3"]),
        nuts_entry(resident_nuts_dense, NUTS_DENSE_SOURCE, NUTS_DENSE_REPLACES,
                   "xor_nuts_dense_untuned",
                   ["xor_fixed_depth_3", "xor_auto", "xor_auto_mass_adapt"])]

    emit({"kernels": [
        {"name": fused_mlp.KERNEL, "route": "cuda", "source": FUSED_SOURCE,
         "replaces": FUSED_REPLACES, "launches": sum(launches.values()),
         "launches_by_path": launches, "max_abs_err": max_abs_err, "ms": ms,
         "ms_is": "torch.profiler device time a launch",
         "event_ms": fused_event_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None, "timed_at": "iris MLP(4,3,3), 32768 chains"},
        resident_entry,
        whole_loop_entry(resident_hmc_dense, DENSE_SOURCE, DENSE_REPLACES, xor_timed_at),
        dict(whole_loop_entry(resident_walk, WALK_SOURCE, WALK_REPLACES,
                              f"{walk_timed[resident_walk.KERNEL][0]}, {walk_at}"),
             other_path=other_walks[resident_walk.KERNEL],
             lanes={"iris_mh_mala": walk_lib.resident_walk_lanes()}),
        dict(whole_loop_entry(resident_walk_dense, WALK_DENSE_SOURCE, WALK_DENSE_REPLACES,
                              f"{walk_timed[resident_walk_dense.KERNEL][0]}, {walk_at}"),
             other_path=other_walks[resident_walk_dense.KERNEL],
             lanes={move: dense_lanes_of(move) for move in DENSE_MOVES}),
        gibbs_entry(resident_walk, WALK_SOURCE, GIBBS_REPLACES, "iris4323_gibbs_extras"),
        gibbs_entry(resident_walk_dense, WALK_DENSE_SOURCE, GIBBS_DENSE_REPLACES,
                    "xor_gibbs_dense_extras"),
        tempering_entry(resident_walk, WALK_SOURCE, TEMPERING_REPLACES,
                        "iris_tempering_mala_extras"),
        tempering_entry(resident_walk_dense, WALK_DENSE_SOURCE, TEMPERING_DENSE_REPLACES,
                        "xor_tempering_mala_dense_extras")] + smc_entries + nuts_entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
