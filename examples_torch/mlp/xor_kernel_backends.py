"""The reference-shaped workflow on the kernel backends.

Counterpart of ``examples/mlp/xor_kernel_backends.py`` on the PyTorch/CUDA
port. A user following the reference API (``SerialSampler.run`` /
``benchmark``) writes exactly this: build a model, bind a transition kernel
into the harness, run. ``backend="auto"`` (the default) sends the whole
sampling loop to a hand-written CUDA kernel whenever the configuration is
eligible (a CUDA device, full batch, an architecture model, a chain count
the kernel's blocks divide); the generic path runs everything else and
stays available as ``backend="scan"``. Kernel-backed chains record sample
and accepted flags and draw from the in-kernel generator (statistically
equivalent, not bit-matched; ``samplers/dispatch.py`` documents the
contract).

Run: python examples_torch/mlp/xor_kernel_backends.py [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.samplers import HMC, NUTS, SamplerHarness, choose_max_depth, sample_chains
from eeyore_tpu_torch.samplers.dispatch import resolve_backend

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]], dtype=np.float32)
XOR_Y = np.array([[0.], [1.], [1.], [0.]], dtype=np.float32)


def main(device="cuda", num_chains=8192, num_epochs=1024, burnin_epochs=512, probe_warmup=256):
    data = (XOR_X, XOR_Y)
    model = MLP(loss=loss_functions["binary_classification"],
                hparams=mlp.Hyperparameters(dims=[2, 2, 1]), dtype=torch.float32, device=device)
    kernel = HMC(model, step=0.05, num_steps=10)

    plan, reason = resolve_backend(kernel, data, num_chains, num_epochs, burnin_epochs,
                                   platform=torch.device(device).type)
    print("backend:", plan.backend if plan else f"generic ({reason})")

    # the reference-shaped single-chain workflow: run() on the harness. On
    # the card this runs one chain block of kernel chains and returns chain 0
    h = SamplerHarness(kernel, data, theta0=0.1 * torch.ones(model.num_params, device=device),
                       generator=torch.Generator(device=device).manual_seed(0))
    t0 = time.perf_counter()
    chain = h.run(num_epochs=num_epochs, num_burnin_epochs=burnin_epochs)
    print(f"run(): {len(chain)} kept draws, acceptance "
          f"{chain.acceptance_rate():.3f}, {time.perf_counter() - t0:.3f}s")

    # many chains through the same public API
    theta0s = 0.1 * torch.randn((num_chains, model.num_params),
                                generator=torch.Generator(device=device).manual_seed(1),
                                device=device)
    t0 = time.perf_counter()
    chains = sample_chains(kernel, torch.Generator(device=device).manual_seed(2), theta0s, data,
                           num_iters=num_epochs, num_burnin_iters=burnin_epochs)
    wall = time.perf_counter() - t0
    print(f"sample_chains: {num_chains} chains x {num_epochs} iters, "
          f"{num_chains * num_epochs / wall / 1e6:.1f}M samples/s (kernel build included)")

    # fixed-budget NUTS at the probed depth (the dense NUTS kernel dispatches
    # the same way)
    d, step = choose_max_depth(model, data, step=0.1, num_warmup=probe_warmup, num_chains=16,
                               generator=torch.Generator(device=device).manual_seed(3))
    print(f"depth probe: frozen max_depth={d}, tuned step={step:.4f}")
    nuts = NUTS(model, step=step, max_depth=d, fixed_budget=True)
    rec = sample_chains(nuts, torch.Generator(device=device).manual_seed(4), theta0s, data,
                        num_iters=num_epochs, num_burnin_iters=burnin_epochs, return_arrays=True)
    nuts_mean = rec["sample"].double().mean(dim=(0, 1))
    print("NUTS sample mean:", np.round(nuts_mean.tolist(), 3))

    # asking for target_val records it in the kernel, beside the accepted flags
    rec = sample_chains(kernel, torch.Generator(device=device).manual_seed(5), theta0s, data,
                        num_iters=num_epochs, num_burnin_iters=burnin_epochs,
                        record_keys=("sample", "accepted", "target_val"), return_arrays=True)
    target = float(rec["target_val"].double().mean())
    acceptance = float(rec["accepted"].double().mean())
    print(f"recorded extras: mean log-target {target:.3f}, acceptance {acceptance:.3f}")
    return {"run_acceptance": chain.acceptance_rate(), "probed_depth": d, "probed_step": step,
            "nuts_mean": nuts_mean.tolist(), "mean_log_target": target,
            "acceptance": acceptance}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
