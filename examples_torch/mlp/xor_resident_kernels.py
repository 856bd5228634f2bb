"""The whole-loop kernels: HMC, MALA, MH, Gibbs and tempering, on staged
data and on data folded into the kernel (the dense variants, the fast path
for datasets of at most 32 rows such as XOR).

Counterpart of ``examples/mlp/xor_resident_kernels.py`` on the PyTorch/CUDA
port: runs the XOR MLP(2,2,1) posterior through each maker of
``eeyore_tpu_torch/ops`` and prints throughput and posterior diagnostics.
On the card every call is one launch of a hand-written CUDA kernel; on the
CPU (``--device cpu``) each maker runs its plain PyTorch version.

Run: python examples_torch/mlp/xor_resident_kernels.py [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops.resident_hmc import make_resident_hmc
from eeyore_tpu_torch.ops.resident_hmc_dense import make_resident_hmc_dense
from eeyore_tpu_torch.ops.resident_tempering import make_resident_tempering
from eeyore_tpu_torch.ops.resident_tempering_dense import make_resident_tempering_dense
from eeyore_tpu_torch.ops.resident_walk import (
    make_resident_gibbs,
    make_resident_mala,
    make_resident_mh,
)
from eeyore_tpu_torch.ops.resident_walk_dense import (
    make_resident_gibbs_dense,
    make_resident_mala_dense,
    make_resident_mh_dense,
)

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]], dtype=np.float32)
XOR_Y = np.array([[0.], [1.], [1.], [0.]], dtype=np.float32)


def main(device="cuda", num_chains=16384, num_iters=1024, burnin=512, staged_block=4096,
         dense_block=8192):
    model = MLP(loss=loss_functions["binary_classification"],
                hparams=mlp.Hyperparameters(dims=[2, 2, 1]), dtype=torch.float32, device=device)
    x, y = XOR_X, XOR_Y
    run = dict(num_iters=num_iters, num_burnin_iters=burnin, device=device)
    staged, dense = dict(run, chain_block=staged_block), dict(run, chain_block=dense_block)
    kernels = {
        "hmc": make_resident_hmc(model, x, y, step=0.05, num_steps=10, **staged),
        "mala": make_resident_mala(model, x, y, step=0.05, **staged),
        "mh": make_resident_mh(model, x, y, scale=0.1, **staged),
        "gibbs": make_resident_gibbs(model, x, y, scales=0.5, **staged),
        # staged_block / 8 independent 8-rung temperature ladders a block;
        # counts column 0 = within-chain accepts, column 1 = swap accepts
        "tempering": make_resident_tempering(model, x, y, num_rungs=8, step=0.05, sampler="MALA",
                                             between_step=10, **staged),
        # the dense variants: the same semantics, the data folded into the kernel
        "hmc-dense": make_resident_hmc_dense(model, x, y, step=0.05, num_steps=10, **dense),
        "mala-dense": make_resident_mala_dense(model, x, y, step=0.05, **dense),
        "mh-dense": make_resident_mh_dense(model, x, y, scale=0.1, **dense),
        "tempering-dense": make_resident_tempering_dense(
            model, x, y, num_rungs=8, step=0.05, sampler="MALA", between_step=10, **dense),
        "gibbs-dense": make_resident_gibbs_dense(model, x, y, scales=0.5, **dense),
    }

    theta0s = 0.1 * torch.randn((num_chains, model.num_params),
                                generator=torch.Generator(device=device).manual_seed(0),
                                device=device)
    kept = num_iters - burnin
    stats = {}
    for name, fn in kernels.items():
        fn(7, theta0s)  # the build (on the card) and a first run
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples, final, acc = fn(7, theta0s)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0

        if name.startswith("tempering"):
            # counts [C, 2]: within-chain accepts, swap accepts; the posterior
            # samples are the COLDEST rung's (every 8th chain, last in a ladder)
            acc_rate = float(acc[:, 0].double().mean()) / kept
            pooled = samples[:, 7::8][:, :512].double()
        else:
            acc_rate = float(acc.double().mean()) / kept
            pooled = samples[:, :512].double()  # [kept, 512, P]
        head = pooled.mean(dim=(0, 1))[:3].tolist()
        stats[name] = {"acceptance": acc_rate, "posterior_mean_head": head}
        print(f"{name:15s} {num_chains * num_iters / elapsed:14,.0f} samples/s  "
              f"acceptance {acc_rate:.3f}  posterior mean head {np.round(head, 3)}")
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
