"""Thousands of HMC chains over the Bayesian MLP(2,2,1) XOR posterior in one
call, with cross-chain diagnostics (multivariate R-hat, pooled means) and
the fused-kernel HMC loop.

Counterpart of ``examples/mlp/xor_hmc_many_chains.py`` on the PyTorch/CUDA
port: the chain axis is a tensor dimension, and on the card
``sample_chains`` runs the whole loop in one launch of the dense HMC kernel
and ``FusedHMC`` launches the fused log-posterior kernel every leapfrog.

Run: python examples_torch/mlp/xor_hmc_many_chains.py [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops.fused_hmc import FusedHMC
from eeyore_tpu_torch.samplers import HMC, sample_chains

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]], dtype=np.float32)
XOR_Y = np.array([[0.], [1.], [1.], [0.]], dtype=np.float32)


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(device="cuda", num_chains=1024, num_iters=1500, burnin=500):
    model = MLP(loss=loss_functions["binary_classification"],
                hparams=mlp.Hyperparameters(dims=[2, 2, 1]), dtype=torch.float32, device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    theta0s = 0.1 * torch.randn((num_chains, model.num_params), generator=generator,
                                device=device)

    # many chains through sample_chains
    kern = HMC(model, step=0.05, num_steps=10)
    start = time.perf_counter()
    chains = sample_chains(kern, generator, theta0s, (XOR_X, XOR_Y), num_iters, burnin)
    synchronize(device)
    elapsed = time.perf_counter() - start
    kept = num_iters - burnin
    print(f"sample_chains HMC: {num_chains} chains x {kept} kept iters "
          f"in {elapsed:.2f}s = {num_chains * num_iters / elapsed:,.0f} samples/s")
    rhat = float(chains.multi_rhat(method="iid")[0])
    print(f"multivariate R-hat across {num_chains} chains: {rhat:.4f}")
    pooled_mean = chains.get_samples().reshape(-1, model.num_params).mean(0)
    print("pooled posterior mean:", np.round(pooled_mean.tolist(), 3))

    # the fused-kernel HMC loop (on CPU tensors, its plain log-posterior)
    fused = FusedHMC(model, XOR_X, XOR_Y, step=0.05, num_steps=10, device=device,
                     use_fused_kernel=True)
    fused.run(0, theta0s, num_iters, burnin)
    synchronize(device)
    start = time.perf_counter()
    state, rec = fused.run(0, theta0s, num_iters, burnin)
    synchronize(device)
    elapsed = time.perf_counter() - start
    print(f"fused-kernel HMC: {num_chains * num_iters / elapsed:,.0f} samples/s")
    return {"multi_rhat": rhat, "pooled_mean": pooled_mean.tolist(),
            "fused_acceptance": float(rec["accepted"].float().mean())}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
