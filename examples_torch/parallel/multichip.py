"""Multi-process demo: chain-sharded HMC, a tempering ladder sharded over
ranks that swap edge rungs with their neighbours, and sharded SMC.

Counterpart of ``examples/parallel/multichip.py`` on the PyTorch/CUDA port:
one process a rank and a device. Run it on every card of a host with

    torchrun --nproc-per-node=<cards> examples_torch/parallel/multichip.py

(NCCL), as two Gloo processes on the CPU with

    RANK=0 WORLD_SIZE=2 python examples_torch/parallel/multichip.py --device cpu \\
        --init-method file:///tmp/multichip_pg &
    RANK=1 WORLD_SIZE=2 python examples_torch/parallel/multichip.py --device cpu \\
        --init-method file:///tmp/multichip_pg

or with neither (a world of one). Each rank prints the shapes of its own
block of every chain-axis output.
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch
import torch.distributed as dist

from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.parallel import (
    chain_mesh,
    initialize_distributed,
    run_power_posterior_sharded,
    run_smc_sharded,
    sample_chains_sharded,
)
from eeyore_tpu_torch.samplers import HMC, PowerPosteriorSampler, SMCSampler

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]], dtype=np.float32)
XOR_Y = np.array([[0.], [1.], [1.], [0.]], dtype=np.float32)


def main(device="cuda", init_method="env://", chains_per_rank=64, num_iters=500, burnin=100,
         ladder_iters=400, ladder_burnin=100, particles_per_rank=512):
    if "RANK" in os.environ:  # torchrun, or the caller, gives the rank and the world
        initialize_distributed(init_method, int(os.environ["WORLD_SIZE"]),
                               int(os.environ["RANK"]), device=device)
    n_ranks = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = chain_mesh(axis_name="chains", devices=device)
    print(f"rank {rank} of {n_ranks}, {mesh}")

    model = MLP(loss=loss_functions["binary_classification"],
                hparams=mlp.Hyperparameters(dims=[2, 2, 1]), dtype=torch.float32, device=device)
    data = (XOR_X, XOR_Y)

    def generator():  # the same seed on every rank: the runners derive each rank's draws
        return torch.Generator(device=model.device).manual_seed(0)

    # 1. chain-sharded HMC: every rank passes the global chains, runs its block
    C = chains_per_rank * n_ranks
    theta0s = 0.1 * torch.randn((C, model.num_params), generator=generator(),
                                device=model.device)
    recorded, _ = sample_chains_sharded(HMC(model, step=0.05, num_steps=10), generator(),
                                        theta0s, data, num_iters, burnin, mesh=mesh)
    acceptance = float(recorded["accepted"].double().mean())
    print(f"rank {rank}: sharded chains {tuple(recorded['sample'].shape)}, "
          f"acceptance {acceptance:.3f}")

    # 2. the tempering ladder, 2 rungs a rank, edge rungs swapped between neighbours
    pp = PowerPosteriorSampler(model, num_chains=2 * n_ranks, sampler="MALA",
                               sampler_kwargs={"step": 0.01}, between_step=5,
                               swap_scheme="even_odd")
    rec = run_power_posterior_sharded(pp, generator(), torch.zeros(model.num_params,
                                                                   device=model.device),
                                      data, ladder_iters, ladder_burnin, mesh=mesh,
                                      axis_name="chains")
    print(f"rank {rank}: sharded ladder {tuple(rec['sample'].shape)}")

    # 3. sharded SMC
    smc = SMCSampler(model, num_particles=particles_per_rank * n_ranks, mutation="MALA",
                     mutation_step=0.05, num_mutation_steps=2)
    particles, log_w, diags = run_smc_sharded(smc, generator(), data, mesh=mesh,
                                              axis_name="chains")
    print(f"rank {rank}: sharded SMC {tuple(particles.shape)}, "
          f"log-evidence {diags['log_evidence']:.3f}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return {"acceptance": acceptance, "ladder_mean": rec["sample"].double().mean().item(),
            "log_evidence": diags["log_evidence"]}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--init-method", default="env://")
    main(**vars(parser.parse_args()))
