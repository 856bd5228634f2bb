"""MALA on a Gamma(k, theta) target, normalized and unnormalized: the
sampler only needs the log-density up to a constant.

Counterpart of ``examples/distributions/gamma.py`` on the PyTorch/CUDA port
(the reference's gamma examples: mala_normalized_target.py,
mala_unnormalized_target.py).

Run: python examples_torch/distributions/gamma.py [--device cpu]
"""

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch.models import DistributionModel
from eeyore_tpu_torch.samplers import MALA, sample_chain


def main(device="cuda", num_iters=11000, num_burnin_iters=1000):
    k, scale = 4.0, 1.5  # mean = k*scale = 6, var = k*scale^2 = 9

    def log_pdf_unnormalized(theta, x, y):
        t = theta[..., 0]
        return (k - 1.0) * torch.log(torch.abs(t)) - torch.abs(t) / scale

    log_norm = k * math.log(scale) + math.lgamma(k)

    def log_pdf_normalized(theta, x, y):
        return log_pdf_unnormalized(theta, x, y) - log_norm

    data = (np.zeros((1, 0)), np.zeros((1, 0)))
    stats = {}
    for name, log_pdf in [("normalized", log_pdf_normalized),
                          ("unnormalized", log_pdf_unnormalized)]:
        model = DistributionModel(log_pdf, num_params=1, dtype=torch.float32, device=device)
        chain = sample_chain(MALA(model, step=0.5), torch.Generator(device=device).manual_seed(0),
                             torch.tensor([6.0], device=device), data, num_iters,
                             num_burnin_iters)
        s = chain.get_samples()[:, 0].double()
        stats[name] = {"acceptance": chain.acceptance_rate(), "mean": float(s.mean()),
                       "var": float(s.var(unbiased=False))}
        print(f"{name:13s} acc={chain.acceptance_rate():.3f} "
              f"mean={stats[name]['mean']:.2f} (true {k * scale}) "
              f"var={stats[name]['var']:.2f} (true {k * scale ** 2})")
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
