"""Host walls of main paths on a CUDA card, first call and steady: the iris
paths of the staged HMC, MH and MALA kernels and of the staged ladder move,
XOR NUTS at depth 3 on the dense NUTS kernel, BASELINE.md configs 1 and 2, the
XOR ladder and XOR Gibbs on the dense walk kernels, bench.py's XOR HMC problem
on the dense HMC kernel, iris SMC MALA on the SMC mutation kernel, the
FusedHMC paths of iris and XOR on the fused log-posterior kernel, and the 2-d
mixture's SMC path on the SMC closure kernel.

    python3 scripts/main_path_walls.py [--root DIR] [--seed 0] [--paths a,b] [--calls 4]

Runs BASELINE.md config 3 (``HMC(tuner=HMCDATuner(l=0.15, e0=0.02),
max_num_steps=64)`` on iris MLP(4,3,3), 32768 chains x 1500 iterations, 500
burn-in) and iris MH (scale 0.1) and MALA (step 0.003) (32768 x 2048, 1024
burn-in) through ``sample_chains(backend="auto")``, the iris ladder (8 rungs
at (i/8)^4, MALA step 0.003 within them, swaps every 10 iterations, 2048 x
1024 burn-in: one chain block of 128 chains) through
``PowerPosteriorSampler.run(backend="auto", all_ladders=True)``, and
fixed-budget XOR NUTS (MLP(2,2,1), depth 3, step 0.1, ``HMCDATuner(d=0.8)``,
32768 x 2048, 1024 burn-in) through ``sample_chains(backend="auto")``; config
1 (MH scale 0.1 on XOR MLP(2,2,1)) and config 2 (MALA step 0.01 on XOR
MLP(2,3,2,1)), 32768 x 2048, 1024 burn-in, through
``sample_chains(backend="auto")``; the XOR ladder (MLP(2,2,1), 8 rungs, MALA
step 0.05, swaps every 10, 2048 x 1024 burn-in: one chain block of 1024
chains) through ``PowerPosteriorSampler.run(backend="auto",
all_ladders=True)``; bench.py's problem (``xor_hmc``: ``HMC(step=0.05,
num_steps=10)`` on XOR MLP(2,2,1), 131072 chains x 256, no burn-in; and
``xor_hmc_staged``, the same through ``backend="resident"``, on the staged HMC
kernel's build of one thread a chain) and XOR Gibbs (``xor_gibbs``:
``Gibbs(scales=0.5)`` on MLP(2,2,1), 32768 x 2048, 1024 burn-in) through
``sample_chains(backend="auto")``; and iris SMC MALA (MLP(4,3,3), 16384
particles, betas (i/20)^4, step 0.003, 5 steps) through
``SMCSampler.run(backend="auto")``; tuned ``FusedHMC`` on config 3's problem
(``iris_fused``: step 0.02, ``HMCDATuner(l=0.15, e0=0.02)``, at most 64
leapfrog steps, 32768 chains x 1500 iterations, 500 burn-in) and on bench.py's
(``xor_fused``: step 0.05, 10 leapfrog steps, 131072 chains x 256), as
chip_smoke.py's phases 4 and 5 run them; and chip_smoke.py's 2-d mixture
(``mixture_smc``: 16384 particles, adaptive, MALA step 0.05, 5 steps, at most
60 stages) through ``SMCSampler.run(backend="auto")``; ``--calls`` times
each (4 by default),
every call ended by ``torch.cuda.synchronize()``: the first call builds the
kernel's function (dispatch's cache), the others reuse it. It prints the
card's name and power limit, then one JSON line a path: the first call's wall,
the steady walls and their median, samples/s (SMC: particle-stage-mutations/s)
at that median, the launches the calls made, and the kernel's CUDA-event time
(the median of three calls of the cached function after a warm-up; SMC: of one
mutation launch at the path's shape, its 16384 prior draws at beta 0.3).
The fused paths give instead the fused kernel's device time a launch (the
mean over its launches in the trace) and the device time of one whole call
of the model's value-and-gradient function (``chip_smoke.device_times``:
each kernel's mean traced launch times its launches a call), both
``torch.profiler`` over 50 calls on the path's initial chains, and the
device's busy share of 50 post-burn-in iterations (the profiled device time
over the host wall of 50 unprofiled ones); the mixture gives the closure
kernel's device time a launch (50 launches at its 16384 base draws, beta
0.3) and its runs' busy share. Beside each, the launches the trace holds and
the launches made: a busy share is a sum over the trace, and reads low when
the profiler dropped launches.
``--root`` imports ``eeyore_tpu_torch`` from another checkout (a ``git
archive`` of another commit), so that two versions compare on one card in one
call.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PATHS = ("config3_hmc", "iris_mh", "iris_mala", "iris_ladder", "xor_nuts_depth_3", "config1_mh",
         "config2_mala", "xor_ladder", "iris_smc_mala", "xor_hmc", "xor_hmc_staged",
         "xor_gibbs", "iris_fused", "xor_fused", "mixture_smc")
SCRIPT_ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--paths", default=",".join(PATHS),
                        help="comma-separated subset of " + ",".join(PATHS))
    parser.add_argument("--calls", type=int, default=4,
                        help="calls of each path: the first, then the steady ones (at least 2)")
    args = parser.parse_args(argv)
    wanted = [p for p in args.paths.split(",") if p]
    if not set(wanted) <= set(PATHS):
        parser.error(f"--paths takes {PATHS}, got {wanted}")
    if args.calls < 2:
        parser.error("--calls takes at least 2")
    sys.path.insert(0, str(SCRIPT_ROOT))
    from chip_smoke import (
        device_times,
        launch_device_ms,
        mixture_base,
        mixture_init,
        mixture_log_pdf,
        traced_kernels,
    )

    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("main_path_walls: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from eeyore_tpu_torch.datasets import XYDataset
    from eeyore_tpu_torch.models import MLP, DistributionModel, loss_functions, mlp
    from eeyore_tpu_torch.ops import (
        fused_mlp,
        resident_hmc,
        resident_hmc_dense,
        resident_nuts_dense,
        resident_smc,
        resident_walk,
        resident_walk_dense,
    )
    from eeyore_tpu_torch.samplers import (
        HMC,
        MALA,
        NUTS,
        Gibbs,
        MetropolisHastings,
        PowerPosteriorSampler,
        SMCSampler,
        sample_chains,
    )
    from eeyore_tpu_torch.ops.fused_hmc import FusedHMC
    from eeyore_tpu_torch.tuners import HMCDATuner

    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    iris = XYDataset.from_eeyore("iris", yonehot=True)
    model = MLP(loss=loss_functions["multiclass_classification"], dtype=torch.float32,
                device=device,
                hparams=mlp.Hyperparameters(dims=[4, 3, 3], activations=[mlp.sigmoid, None]))
    xor = XYDataset.from_eeyore("xor")
    xor_model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                    device=device, hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
    rng = np.random.default_rng(args.seed)
    iris_theta0s = torch.as_tensor(0.1 * rng.normal(size=(32768, model.num_params)),
                                   dtype=torch.float32, device=device)
    xor_theta0s = torch.as_tensor(0.1 * rng.normal(size=(32768, xor_model.num_params)),
                                  dtype=torch.float32, device=device)
    xor2321_model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                        device=device, hparams=mlp.Hyperparameters(dims=[2, 3, 2, 1]))
    xor2321_theta0s = torch.as_tensor(0.1 * rng.normal(size=(32768, xor2321_model.num_params)),
                                      dtype=torch.float32, device=device)
    rungs = torch.as_tensor(0.1 * rng.normal(size=(8, model.num_params)), dtype=torch.float32,
                            device=device)
    xor_rungs = torch.as_tensor(0.1 * rng.normal(size=(8, xor_model.num_params)),
                                dtype=torch.float32, device=device)
    bench_theta0s = torch.as_tensor(0.1 * rng.normal(size=(131072, xor_model.num_params)),
                                    dtype=torch.float32, device=device)
    ladders = {
        "iris_ladder": (PowerPosteriorSampler(model, num_chains=8, sampler="MALA",
                                              sampler_kwargs={"step": 0.003}, between_step=10,
                                              swap_scheme="even_odd"), rungs),
        "xor_ladder": (PowerPosteriorSampler(xor_model, num_chains=8, sampler="MALA",
                                             sampler_kwargs={"step": 0.05}, between_step=10,
                                             swap_scheme="even_odd"), xor_rungs)}
    smc = SMCSampler(model, 16384, betas=[(i / 20) ** 4 for i in range(21)], mutation="MALA",
                     mutation_step=0.003, num_mutation_steps=5)
    mixture = DistributionModel(mixture_log_pdf, 2, dtype=torch.float32, device=device)
    mixture_smc = SMCSampler(mixture, 16384, betas="adaptive", mutation="MALA",
                             mutation_step=0.05, num_mutation_steps=5, init_sampler=mixture_init,
                             base_log_pdf=mixture_base, max_stages=60)
    empty = (np.zeros((1, 0)), np.zeros((1, 0)))
    fused = {
        "iris_fused": (lambda: FusedHMC(model, iris.x, iris.y, step=0.02,
                                        tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64,
                                        device=device), iris_theta0s, 1500, 500),
        "xor_fused": (lambda: FusedHMC(xor_model, xor.x, xor.y, step=0.05, num_steps=10,
                                       device=device), bench_theta0s, 256, 0)}

    def chains_call(kernel, theta0s, data, iters, burnin, backend="auto"):
        return lambda gen: sample_chains(kernel, gen, theta0s, data, iters, burnin,
                                         backend=backend)

    paths = {
        "config3_hmc": (HMC(model, tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64),
                        iris_theta0s, (iris.x, iris.y), 1500, 500),
        "iris_mh": (MetropolisHastings(model, scale=0.1), iris_theta0s, (iris.x, iris.y),
                    2048, 1024),
        "iris_mala": (MALA(model, step=0.003), iris_theta0s, (iris.x, iris.y), 2048, 1024),
        "iris_ladder": (ladders["iris_ladder"][0], None, (iris.x, iris.y), 2048, 1024),
        "xor_nuts_depth_3": (NUTS(xor_model, step=0.1, max_depth=3, fixed_budget=True,
                                  tuner=HMCDATuner(d=0.8)), xor_theta0s, (xor.x, xor.y),
                             2048, 1024),
        "config1_mh": (MetropolisHastings(xor_model, scale=0.1), xor_theta0s, (xor.x, xor.y),
                       2048, 1024),
        "config2_mala": (MALA(xor2321_model, step=0.01), xor2321_theta0s, (xor.x, xor.y), 2048,
                         1024),
        "xor_ladder": (ladders["xor_ladder"][0], None, (xor.x, xor.y), 2048, 1024),
        "iris_smc_mala": (smc, None, (iris.x, iris.y), 20, 0),
        "xor_hmc": (HMC(xor_model, step=0.05, num_steps=10), bench_theta0s, (xor.x, xor.y),
                    256, 0),
        "xor_hmc_staged": (HMC(xor_model, step=0.05, num_steps=10), bench_theta0s,
                           (xor.x, xor.y), 256, 0),
        "xor_gibbs": (Gibbs(xor_model, scales=0.5), xor_theta0s, (xor.x, xor.y), 2048, 1024)}
    modules = (resident_hmc, resident_hmc_dense, resident_walk, resident_nuts_dense,
               resident_walk_dense, resident_smc, fused_mlp)

    def reset_launches():
        for module in modules:
            for key in module.launch_counts:
                module.launch_counts[key] = 0

    def read_launches():
        return {k: v for module in modules for k, v in module.launch_counts.items()}

    def traced_count(traced, name):  # launches of kernels named like ``name`` in a trace
        return sum(n for k, (n, _) in traced.items() if name in k)

    def walls_of(call):
        walls, out = [], None
        for _ in range(args.calls):
            del out
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
        return walls, out

    for name in wanted:
        if name in fused:
            make, theta0s, iters, burnin = fused[name]
            hmc = make()
            reset_launches()
            walls, (state, _) = walls_of(lambda: hmc.run(args.seed, theta0s, iters, burnin,
                                                         record_keys=("sample", "accepted")))
            launches = read_launches()
            fn_times = device_times(lambda: hmc.vg(theta0s), 50)
            kernel_ms, traced = launch_device_ms(lambda: hmc.vg(theta0s), fused_mlp.KERNEL, 50)
            gen = torch.Generator(device=device).manual_seed(args.seed)

            def steps(state, first, n=50):
                for i in range(first, first + n):
                    state, _ = hmc.step_fn(state, i, burnin, generator=gen)
                return state

            state = steps(state, iters)
            torch.cuda.synchronize()
            start = time.perf_counter()
            state = steps(state, iters + 50)
            torch.cuda.synchronize()
            window = time.perf_counter() - start
            reset_launches()
            busy = traced_kernels(lambda: steps(state, iters + 100))[1]
            made = fused_mlp.launch_counts[fused_mlp.KERNEL]
            steady = float(np.median(walls[1:]))
            print(json.dumps({
                "path": name, "root": args.root, "chains": theta0s.shape[0],
                "iterations": iters, "burnin": burnin, "first_call_seconds": walls[0],
                "steady_seconds": walls[1:], "steady_median_seconds": steady,
                "samples_per_s_steady": theta0s.shape[0] * iters / steady,
                "launches": launches,
                "kernel_ms": kernel_ms, "kernel_launches_traced": traced,
                "kernel_ms_is": "device time a launch (torch.profiler, 50 calls)",
                "fn_device_ms": fn_times["ms"], "fn_device_ms_by_kernel": fn_times["by_kernel"],
                "fn_launches_traced": fn_times["launches_traced"],
                "fn_launches_made": fn_times["launches_made"],
                "device_busy_share_50_iterations":
                    sum(ms for _, ms in busy.values()) / 1e3 / window,
                "busy_kernel_launches_traced": traced_count(busy, fused_mlp.KERNEL),
                "busy_kernel_launches_made": made,
                "card": card}), flush=True)
            del hmc, state
            torch.cuda.empty_cache()
            continue
        if name == "mixture_smc":
            gen = torch.Generator(device=device).manual_seed(args.seed + 1)
            reset_launches()
            walls, (_, diags) = walls_of(lambda: mixture_smc.run(gen, empty, backend="auto"))
            launches = read_launches()
            reset_launches()
            busy = traced_kernels(lambda: mixture_smc.run(gen, empty, backend="auto"))[1]
            made = resident_smc.launch_counts[resident_smc.CLOSURE_KERNEL]
            mutation = resident_smc.make_resident_smc_mutation(
                mixture, *empty, 0.05, 5, chain_block=1024, mutation="MALA",
                base_log_pdf=mixture_base, device=device)
            draws = mixture_init(torch.Generator(device=device).manual_seed(args.seed), 16384)
            kernel_ms, traced = launch_device_ms(lambda: mutation(args.seed, 0.3, draws),
                                                 resident_smc.CLOSURE_KERNEL, 50)
            steady = float(np.median(walls[1:]))
            stages = len(diags["beta"])
            print(json.dumps({
                "path": name, "root": args.root, "particles": 16384, "stages_last_call": stages,
                "first_call_seconds": walls[0], "steady_seconds": walls[1:],
                "steady_median_seconds": steady,
                "particle_stage_mutations_per_s_steady": 16384 * stages * 5 / steady,
                "launches": launches,
                "kernel_ms": kernel_ms, "kernel_launches_traced": traced,
                "kernel_ms_is": "device time a launch (torch.profiler, 50 launches)",
                "device_busy_share_one_run": sum(ms for _, ms in busy.values()) / 1e3 / steady,
                "busy_kernel_launches_traced": traced_count(busy, resident_smc.CLOSURE_KERNEL),
                "busy_kernel_launches_made": made,
                "card": card}), flush=True)
            torch.cuda.empty_cache()
            continue
        kernel, theta0s, data, iters, burnin = paths[name]
        if name in ladders:
            def call(gen, data=data, iters=iters, burnin=burnin, name=name):
                sampler, inits = ladders[name]
                return sampler.run(gen, inits, data, iters, burnin, backend="auto",
                                   all_ladders=True)
        elif kernel is smc:
            def call(gen, data=data):
                return smc.run(gen, data, backend="auto")
        else:
            call = chains_call(kernel, theta0s, data, iters, burnin,
                               "resident" if name == "xor_hmc_staged" else "auto")
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        for module in modules:
            for key in module.launch_counts:
                module.launch_counts[key] = 0
        walls = []
        for _ in range(args.calls):
            torch.cuda.synchronize()
            start = time.perf_counter()
            chains = call(gen)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            del chains
        launches = {k: v for module in modules for k, v in module.launch_counts.items()}
        if kernel is smc:  # one mutation launch at the path's shape
            mutation = resident_smc.make_resident_smc_mutation(
                model, iris.x, iris.y, smc.mutation_step, smc.num_mutation_steps,
                chain_block=1024, mutation=smc.mutation, device=device)
            prior = model.prior.sample(torch.Generator(device=device).manual_seed(args.seed),
                                       (smc.num_particles,))

            def fn(seed, _, mutation=mutation, prior=prior):
                return mutation(seed, 0.3, prior)
            theta0s = prior
        else:
            ((key, fn),) = kernel._backend_cache.items()
        if theta0s is None:  # the ladder's chain block (key[2]), every rung's init tiled
            inits = ladders[name][1]
            theta0s = inits.repeat(key[2] // inits.shape[0], 1)
        fn(args.seed, theta0s)
        times = []
        for _ in range(3):
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin.record()
            fn(args.seed, theta0s)
            end.record()
            torch.cuda.synchronize()
            times.append(begin.elapsed_time(end))
        steady = float(np.median(walls[1:]))
        work = (theta0s.shape[0] * iters if kernel is not smc
                else smc.num_particles * iters * smc.num_mutation_steps)
        print(json.dumps({"path": name, "root": args.root, "chains": theta0s.shape[0],
                          "iterations": iters, "burnin": burnin, "first_call_seconds": walls[0],
                          "steady_seconds": walls[1:], "steady_median_seconds": steady,
                          "samples_per_s_steady": work / steady,
                          "launches": launches, "kernel_ms": sorted(times)[1],
                          "kernel_ms_runs": times, "card": card}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
