"""Fixed-budget NUTS at chain scale: no-u-turn trajectories of a fixed
number of leapfrogs, masked where adaptive NUTS would stop, that draw the
same samples as adaptive NUTS at the same max_depth, bit for bit.

Counterpart of ``examples/distributions/nuts_fixed_budget.py`` on the
PyTorch/CUDA port. Adaptive NUTS makes every chain of a batch wait for the
deepest tree; ``fixed_budget=True`` runs 2^max_depth - 1 leapfrogs with
masked early stopping. On the card, an architecture model (MLP, logistic
regression) with a fixed budget runs on the whole-loop NUTS kernels; the
``DistributionModel`` here runs the generic path.

Run: python examples_torch/distributions/nuts_fixed_budget.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch.models import DistributionModel
from eeyore_tpu_torch.samplers import NUTS, choose_max_depth, sample_chains


def main(device="cuda", num_chains=256, num_iters=500, num_burnin_iters=100, probe_warmup=200):
    cov = np.array([[1.0, 0.8], [0.8, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32, device=device)
    model = DistributionModel(lambda t, x, y: -0.5 * ((t @ prec) * t).sum(-1), num_params=2,
                              dtype=torch.float32, device=device)
    data = (np.zeros((1, 0)), np.zeros((1, 0)))

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    theta0s = 0.5 * torch.randn((num_chains, 2), generator=generator(1), device=device)
    run = dict(num_iters=num_iters, num_burnin_iters=num_burnin_iters, return_arrays=True)

    adaptive = NUTS(model, step=0.4, max_depth=4)
    fixed = NUTS(model, step=0.4, max_depth=4, fixed_budget=True)
    rec_a = sample_chains(adaptive, generator(0), theta0s, data, **run)
    rec_f = sample_chains(fixed, generator(0), theta0s, data, **run)

    same = torch.equal(rec_a["sample"], rec_f["sample"])
    pooled = rec_f["sample"].double().reshape(-1, 2)
    depth = float(rec_f["depth"].double().mean())
    leapfrogs = float(rec_f["num_leapfrogs"].double().mean())
    print(f"bit-identical to adaptive NUTS: {same}")
    print(f"pooled mean: {np.round(pooled.mean(0).tolist(), 3)} (true [0, 0])")
    print(f"pooled cov diag: {np.round(pooled.var(0).tolist(), 3)} (true [1, 1])")
    print(f"mean tree depth: {depth:.2f}, mean leapfrogs/transition: {leapfrogs:.2f} "
          "(budget 15)")
    assert same

    # let the framework pick the frozen budget: a short adaptive warm-up
    # freezes max_depth at the p95 kept tree depth and returns the tuned step
    depth_probe, step = choose_max_depth(model, data, step=0.4, num_warmup=probe_warmup,
                                         theta0s=theta0s[:8], generator=generator(2))
    print(f"choose_max_depth: frozen depth {depth_probe}, tuned step {step:.3f}")
    auto = NUTS(model, step=step, max_depth=depth_probe, fixed_budget=True)
    rec = sample_chains(auto, generator(3), theta0s, data, **run)
    pooled2 = rec["sample"].double().reshape(-1, 2)
    print(f"auto-budget pooled mean: {np.round(pooled2.mean(0).tolist(), 3)} (true [0, 0])")

    # max_depth="auto" runs the probe the first time the kernel sees data
    # (inside sample_chains) and freezes (depth, step); a prior-less
    # DistributionModel gives the probe its inits
    auto2 = NUTS(model, step=0.4, max_depth="auto")
    auto2.resolve_auto_budget(data, generator=generator(4), num_warmup=probe_warmup,
                              theta0s=theta0s[:8])
    print(f"max_depth='auto': probed depth {auto2.max_depth}, step {auto2.step0:.3f}")
    rec3 = sample_chains(auto2, generator(5), theta0s, data, **run)
    pooled3 = rec3["sample"].double().reshape(-1, 2)
    print(f"max_depth='auto' pooled mean: {np.round(pooled3.mean(0).tolist(), 3)} "
          "(true [0, 0])")
    return {"same": same, "pooled_mean": pooled.mean(0).tolist(),
            "pooled_var": pooled.var(0).tolist(), "mean_depth": depth,
            "mean_leapfrogs": leapfrogs, "probed_depth": depth_probe, "probed_step": step,
            "auto_pooled_mean": pooled2.mean(0).tolist(),
            "auto_depth": auto2.max_depth, "auto_step": float(auto2.step0),
            "auto2_pooled_mean": pooled3.mean(0).tolist()}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
