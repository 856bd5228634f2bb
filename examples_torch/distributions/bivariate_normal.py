"""Sampling a correlated bivariate normal with the whole sampler zoo, and
validating each chain against the exact sampler with moments and MMD.

Counterpart of ``examples/distributions/bivariate_normal.py`` on the
PyTorch/CUDA port (the reference's bivariate_normal examples:
metropolis_hastings.py, mala.py, hmc.py, hmc_with_dual_averaging.py, am.py,
ram.py, power_posteriors.py). A ``DistributionModel`` has no kernel: every
chain runs the generic path on ``device``.

Run: python examples_torch/distributions/bivariate_normal.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch.kernels import IsoSEKernel
from eeyore_tpu_torch.models import DistributionModel
from eeyore_tpu_torch.samplers import (
    AM,
    HMC,
    MALA,
    NUTS,
    RAM,
    MetropolisHastings,
    PowerPosteriorSampler,
    sample_chain,
)
from eeyore_tpu_torch.stats import mmd
from eeyore_tpu_torch.tuners import HMCDATuner


def main(device="cuda", num_iters=11000, num_burnin_iters=1000):
    cov = np.array([[1.0, 0.7], [0.7, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32, device=device)
    model = DistributionModel(lambda t, x, y: -0.5 * ((t @ prec) * t).sum(-1), num_params=2,
                              dtype=torch.float32, device=device)
    data = (np.zeros((1, 0)), np.zeros((1, 0)))
    theta0 = torch.tensor([2.0, -2.0], device=device)

    # exact samples for the MMD discrepancy check
    exact = torch.as_tensor(np.random.default_rng(99).multivariate_normal(np.zeros(2), cov, 500),
                            dtype=torch.float32, device=device)

    samplers = {
        "MH": MetropolisHastings(model, scale=0.8),
        "MALA": MALA(model, step=0.5),
        "HMC": HMC(model, step=0.3, num_steps=10),
        "HMC+DA": HMC(model, tuner=HMCDATuner(l=1.5)),
        "AM": AM(model),
        "RAM": RAM(model),
        "NUTS": NUTS(model, step=0.4, max_depth=8),
    }
    stats = {}
    for name, kern in samplers.items():
        chain = sample_chain(kern, torch.Generator(device=device).manual_seed(0), theta0, data,
                             num_iters, num_burnin_iters)
        s = chain.get_samples()
        d = float(mmd(s[::20], exact, IsoSEKernel()))
        stats[name] = {"acceptance": chain.acceptance_rate(), "mean": s.mean(0).tolist(),
                       "mc_se": chain.mc_se().tolist(), "multi_ess": float(chain.multi_ess()),
                       "mmd": d}
        print(f"{name:7s} acc={chain.acceptance_rate():.3f} "
              f"mean={np.round(stats[name]['mean'], 3)} "
              f"mc_se={np.round(stats[name]['mc_se'], 3)} "
              f"multi_ess={stats[name]['multi_ess']:.0f} mmd={d:.3f}")

    pp = PowerPosteriorSampler(model, num_chains=5, sampler="MALA",
                               sampler_kwargs={"step": 0.5}, between_step=10)
    chains = pp.run(torch.Generator(device=device).manual_seed(0), theta0, data, num_iters,
                    num_burnin_iters)
    cold = chains.get_chain(pp.default_indicator()).double().cpu().numpy()
    stats["PP"] = {"cold_mean": cold.mean(0).tolist(),
                   "cold_cov": np.cov(cold, rowvar=False).tolist()}
    print(f"PP      cold mean={cold.mean(0).round(3)} "
          f"cov=\n{np.cov(cold, rowvar=False).round(3)}")
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
