"""Sampling a two-component bivariate normal mixture: the multimodal target
where plain MH and MALA get stuck and AM (with the softabs PD-transform)
and tempering cross between the modes.

Counterpart of ``examples/distributions/bivariate_normal_mixture.py`` on the
PyTorch/CUDA port (the reference's bivariate_normal_mixture examples; am.py
uses transform=softabs there).

Run: python examples_torch/distributions/bivariate_normal_mixture.py [--device cpu]
"""

import argparse
import functools
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch.models import DistributionModel
from eeyore_tpu_torch.samplers import (
    AM,
    HMC,
    MetropolisHastings,
    PowerPosteriorSampler,
    sample_chain,
)
from eeyore_tpu_torch.stats import softabs


def make_model(mu=2.0, device="cuda"):
    def log_pdf(theta, x, y):
        l1 = -0.5 * torch.sum((theta - mu) ** 2, dim=-1)
        l2 = -0.5 * torch.sum((theta + mu) ** 2, dim=-1)
        return torch.logaddexp(l1, l2) - math.log(2.0)

    return DistributionModel(log_pdf, num_params=2, dtype=torch.float32, device=device)


def main(device="cuda", num_iters=11000, num_burnin_iters=1000):
    model = make_model(device=device)
    data = (np.zeros((1, 0)), np.zeros((1, 0)))
    theta0 = torch.tensor([2.0, 2.0], device=device)

    samplers = {
        "MH": MetropolisHastings(model, scale=1.0),
        "HMC": HMC(model, step=0.5, num_steps=10),
        "AM+softabs": AM(model, transform=functools.partial(softabs, a=1000.0)),
    }
    stats = {}
    for name, kern in samplers.items():
        chain = sample_chain(kern, torch.Generator(device=device).manual_seed(0), theta0, data,
                             num_iters, num_burnin_iters)
        s = chain.get_samples()
        frac_pos = float((s[:, 0] > 0).double().mean())
        stats[name] = {"acceptance": chain.acceptance_rate(), "mean": s.mean(0).tolist(),
                       "mode_balance": frac_pos}
        print(f"{name:11s} acc={chain.acceptance_rate():.3f} "
              f"mean={np.round(stats[name]['mean'], 2)} mode-balance={frac_pos:.2f}")

    pp = PowerPosteriorSampler(model, num_chains=6, sampler="MALA",
                               sampler_kwargs={"step": 0.5}, between_step=5,
                               swap_scheme="even_odd")
    chains = pp.run(torch.Generator(device=device).manual_seed(0), theta0, data, num_iters,
                    num_burnin_iters)
    cold = chains.get_chain(pp.default_indicator())
    frac_pos = float((cold[:, 0] > 0).double().mean())
    stats["PP"] = {"cold_mean": cold.mean(0).tolist(), "mode_balance": frac_pos}
    print(f"{'PP':11s} cold mean={np.round(stats['PP']['cold_mean'], 2)} "
          f"mode-balance={frac_pos:.2f} (tempering crosses between modes)")
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
