"""Adaptive-tempering SMC on the XOR MLP posterior: the ESS-bisection ladder
chooses each next temperature so that the reweighted effective sample size
stays at half the particle count; easy paths collapse to a few stages
where the fixed quartic ladder always pays 10.

Counterpart of ``examples/mlp/xor_smc_adaptive.py`` on the PyTorch/CUDA port.

Run: python examples_torch/mlp/xor_smc_adaptive.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.samplers import SMCSampler

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])


def main(device="cuda", num_particles=2048):
    model = MLP(loss=loss_functions["binary_classification"],
                hparams=mlp.Hyperparameters(dims=[2, 2, 1]), dtype=torch.float32, device=device)
    fixed = SMCSampler(model, num_particles=num_particles, mutation="MALA",
                       mutation_step=0.1, num_mutation_steps=3)
    adaptive = SMCSampler(model, num_particles=num_particles, betas="adaptive",
                          mutation="MALA", mutation_step=0.1, num_mutation_steps=3,
                          adaptive_target_ess=0.5)

    state_f, diags_f = fixed.run(torch.Generator(device=device).manual_seed(0), (XOR_X, XOR_Y))
    state_a, diags_a = adaptive.run(torch.Generator(device=device).manual_seed(0), (XOR_X, XOR_Y))

    print(f"fixed quartic ladder: {len(diags_f['beta'])} stages, "
          f"log evidence {diags_f['log_evidence']:.3f}")
    print(f"adaptive ladder:      {diags_a['num_stages']} stages "
          f"(betas {np.round(diags_a['beta'].numpy(), 4)}), "
          f"log evidence {diags_a['log_evidence']:.3f}")
    difference = float((SMCSampler.estimate(state_f) - SMCSampler.estimate(state_a)).abs().max())
    print(f"max posterior-mean difference: {difference:.4f}")
    assert abs(diags_f["log_evidence"] - diags_a["log_evidence"]) < 0.2
    assert diags_a["num_stages"] <= len(diags_f["beta"])
    return {"fixed_log_evidence": diags_f["log_evidence"],
            "adaptive_log_evidence": diags_a["log_evidence"],
            "adaptive_stages": diags_a["num_stages"], "max_mean_difference": difference}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
