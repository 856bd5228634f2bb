"""Bayesian logistic regression on the Swiss banknotes dataset with MH and
RAM, plus posterior-predictive accuracy.

Counterpart of ``examples/logistic_regression/banknotes.py`` on the
PyTorch/CUDA port (the reference's banknotes examples:
metropolis_hastings.py, ram.py). On the card MH runs on the whole-loop walk
kernel (a chain block of it, chain 0 returned); RAM has no kernel and runs
the generic path.

Run: python examples_torch/logistic_regression/banknotes.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import LogisticRegression, logistic_regression, loss_functions
from eeyore_tpu_torch.samplers import RAM, MetropolisHastings, sample_chain


def main(device="cuda", num_iters=11000, num_burnin_iters=1000):
    ds = XYDataset.from_eeyore("banknotes")
    # standardize features for a well-conditioned posterior
    x = (ds.x - ds.x.mean(0)) / ds.x.std(0)
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    yt = torch.as_tensor(ds.y, dtype=torch.float32, device=device)

    model = LogisticRegression(
        loss=loss_functions["binary_classification"], dtype=torch.float32, device=device,
        hparams=logistic_regression.Hyperparameters(input_size=6, output_size=1))
    theta0 = torch.zeros(model.num_params, device=device)

    stats = {}
    for name, kern in [("MH", MetropolisHastings(model, scale=0.1)),
                       ("RAM", RAM(model, cov0=0.01 * np.eye(model.num_params)))]:
        chain = sample_chain(kern, torch.Generator(device=device).manual_seed(0), theta0,
                             (xt, yt), num_iters, num_burnin_iters)
        preds = model.forward(chain.mean().to(device=device, dtype=torch.float32), xt)
        acc = float(((preds > 0.5) == (yt > 0.5)).double().mean())
        stats[name] = {"acceptance": chain.acceptance_rate(),
                       "multi_ess": float(chain.multi_ess()), "accuracy": acc}
        print(f"{name:4s} acceptance={chain.acceptance_rate():.3f} "
              f"multi_ess={stats[name]['multi_ess']:.0f} "
              f"posterior-mean classification accuracy={acc:.3f}")
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
