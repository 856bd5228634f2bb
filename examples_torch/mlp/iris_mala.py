"""MALA over the weights of an MLP(4,3,3) iris classifier, the reference's
flagship example, with in-memory and file-backed chain storage.

Counterpart of ``examples/mlp/iris_mala.py`` (11000 epochs, 1000 burn-in,
step 0.003, an N(0, sqrt(3)) prior, float32) on the PyTorch/CUDA port.

Run: python examples_torch/mlp/iris_mala.py [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch.chains import ChainFile
from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, IIDNormalPrior, loss_functions, mlp
from eeyore_tpu_torch.samplers import MALA, SamplerHarness


def main(device="cuda", num_epochs=11000, num_burnin_epochs=1000):
    iris = XYDataset.from_eeyore("iris", yonehot=True)
    model = MLP(loss=loss_functions["multiclass_classification"],
                hparams=mlp.Hyperparameters(dims=[4, 3, 3], activations=[mlp.sigmoid, None]),
                dtype=torch.float32, device=device)
    model.prior = IIDNormalPrior.isotropic(model.num_params, np.sqrt(3.0), dtype=torch.float32,
                                           device=device)

    generator = torch.Generator(device=device).manual_seed(0)
    theta0 = model.prior.sample(generator)

    harness = SamplerHarness(MALA(model, step=0.003), (iris.x, iris.y), theta0=theta0,
                             generator=generator)
    chain = harness.run(num_epochs=num_epochs, num_burnin_epochs=num_burnin_epochs, verbose=True)

    stats = {"acceptance_rate": chain.acceptance_rate(), "mean": chain.mean().tolist(),
             "mc_se": chain.mc_se().tolist(), "multi_ess": float(chain.multi_ess())}
    print("acceptance rate:", stats["acceptance_rate"])
    print("Monte Carlo mean:", np.round(stats["mean"], 3))
    print("Monte Carlo SE:", np.round(stats["mc_se"], 3))
    print("multivariate ESS:", round(stats["multi_ess"]))

    # file-backed storage round trip (the reference's chainfile variant)
    with tempfile.TemporaryDirectory() as tmp:
        chain.to_chainfile(path=tmp, mode="w")
        back = ChainFile(keys=("sample", "target_val", "accepted"), path=tmp).to_chainlist()
        stats["chainfile_samples"] = len(back)
        print("chainfile round-trip samples:", len(back))
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
