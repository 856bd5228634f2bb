"""Host walls of the iris main paths of the staged HMC, MH and MALA kernels,
first call and steady, on a CUDA card.

    python3 scripts/main_path_walls.py [--root DIR] [--seed 0]

Runs BASELINE.md config 3 (``HMC(tuner=HMCDATuner(l=0.15, e0=0.02),
max_num_steps=64)`` on iris MLP(4,3,3), 32768 chains x 1500 iterations, 500
burn-in) and iris MH (scale 0.1) and MALA (step 0.003) (32768 x 2048, 1024
burn-in) through ``sample_chains(backend="auto")`` four times each, every
call ended by ``torch.cuda.synchronize()``: the first call builds the
kernel's function (dispatch's cache), the other three reuse it. It prints
the card's name and power limit, then one JSON line a path: the first
call's wall, the steady walls and their median, samples/s at that median,
the launches the calls made, and the kernel's CUDA-event time (the median of
three calls of the cached function after a warm-up). ``--root`` imports
``eeyore_tpu_torch`` from another checkout (a ``git archive`` of another
commit), so that two versions compare on one card in one call.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("main_path_walls: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from eeyore_tpu_torch.datasets import XYDataset
    from eeyore_tpu_torch.models import MLP, loss_functions, mlp
    from eeyore_tpu_torch.ops import resident_hmc, resident_walk
    from eeyore_tpu_torch.samplers import HMC, MALA, MetropolisHastings, sample_chains
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
    rng = np.random.default_rng(args.seed)
    theta0s = torch.as_tensor(0.1 * rng.normal(size=(32768, model.num_params)),
                              dtype=torch.float32, device=device)
    paths = (("config3_hmc", HMC(model, tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64),
              1500, 500),
             ("iris_mh", MetropolisHastings(model, scale=0.1), 2048, 1024),
             ("iris_mala", MALA(model, step=0.003), 2048, 1024))
    for name, kernel, iters, burnin in paths:
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        for module in (resident_hmc, resident_walk):
            for key in module.launch_counts:
                module.launch_counts[key] = 0
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            start = time.perf_counter()
            chains = sample_chains(kernel, gen, theta0s, (iris.x, iris.y), iters, burnin,
                                   backend="auto")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            del chains
        launches = {**resident_hmc.launch_counts, **resident_walk.launch_counts}
        (fn,) = kernel._backend_cache.values()
        fn(args.seed, theta0s)
        times = []
        for _ in range(3):
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin.record()
            fn(args.seed, theta0s)
            end.record()
            torch.cuda.synchronize()
            times.append(begin.elapsed_time(end))
        steady = sorted(walls[1:])[1]
        print(json.dumps({"path": name, "root": args.root, "chains": theta0s.shape[0],
                          "iterations": iters, "burnin": burnin, "first_call_seconds": walls[0],
                          "steady_seconds": walls[1:], "steady_median_seconds": steady,
                          "samples_per_s_steady": theta0s.shape[0] * iters / steady,
                          "launches": launches, "kernel_ms": sorted(times)[1],
                          "kernel_ms_runs": times, "card": card}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
