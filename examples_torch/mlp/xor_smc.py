"""Tempered SMC over the Bayesian MLP(2,2,1) XOR posterior: 16k particles
annealed from the prior with ESS-triggered systematic resampling, MALA
mutations, and a model-evidence estimate (BASELINE.md config 5).

Counterpart of ``examples/mlp/xor_smc.py`` on the PyTorch/CUDA port: on the
card ``SMCSampler.run`` launches the SMC mutation kernel once a stage.

Run: python examples_torch/mlp/xor_smc.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.samplers import SMCSampler

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]], dtype=np.float32)
XOR_Y = np.array([[0.], [1.], [1.], [0.]], dtype=np.float32)


def main(device="cuda", num_particles=16384):
    model = MLP(loss=loss_functions["binary_classification"],
                hparams=mlp.Hyperparameters(dims=[2, 2, 1]), dtype=torch.float32, device=device)

    betas = [(i / 20) ** 4 for i in range(21)]  # the reference's quartic ladder, 20 rungs
    smc = SMCSampler(model, num_particles=num_particles, betas=betas,
                     mutation="MALA", mutation_step=0.05, num_mutation_steps=5)
    state, diags = smc.run(torch.Generator(device=device).manual_seed(0), (XOR_X, XOR_Y))

    print(f"{num_particles} particles through {len(betas) - 1} tempering stages")
    print("per-stage ESS:", np.round(diags["ess"].numpy()).astype(int).tolist())
    print("resampled at stages:", np.where(diags["resampled"].numpy())[0].tolist())
    print("mutation acceptance:", np.round(diags["mutation_acceptance"].numpy(), 3).tolist())
    print(f"log evidence estimate: {diags['log_evidence']:.3f}")

    post_mean = SMCSampler.estimate(state)
    preds = model.forward(post_mean, torch.as_tensor(XOR_X, device=device))
    print("posterior-mean XOR predictions:", np.round(preds.cpu().numpy(), 2).ravel())
    return {"ess": diags["ess"].tolist(),
            "mutation_acceptance": diags["mutation_acceptance"].tolist(),
            "log_evidence": diags["log_evidence"], "predictions": preds.cpu().ravel().tolist()}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
