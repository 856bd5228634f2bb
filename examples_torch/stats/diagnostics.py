"""Diagnostics walkthrough: cov/cor, INSE against iid MC covariance, MC-SE,
multivariate ESS and R-hat on simulated AR(1) chains.

Counterpart of ``examples/stats/diagnostics.py`` on the PyTorch/CUDA port
(the reference's stats examples: cov.py, cor.py, inse_mc_cov.py,
multi_ess.py, multi_rhat.py; here checked against the analytic AR(1)
autocovariance). The chains are simulated with numpy and moved to
``device``; the statistics run in float64 there.

Run: python examples_torch/stats/diagnostics.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from eeyore_tpu_torch import stats as st
from eeyore_tpu_torch.chains import ChainLists


def ar1(n, p, rho, rng):
    x = np.zeros((n, p))
    x[0] = rng.normal(size=p)
    noise = rng.normal(size=(n, p)) * np.sqrt(1 - rho**2)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + noise[i]
    return x


def main(device="cuda", num_iters=4000):
    rng = np.random.default_rng(0)
    rho = 0.7
    chains = torch.as_tensor(np.stack([ar1(num_iters, 2, rho, rng) for _ in range(4)]),
                             device=device)

    x = chains[0]
    ess = float(st.multi_ess(x))
    stats = {"cov": st.cov(x).tolist(), "cor": st.cor(x).tolist(),
             "iid_mc_cov": st.mc_cov(x, method="iid").tolist(),
             "inse_mc_cov": st.mc_cov(x, method="inse").tolist(),
             "mc_se": st.mc_se(x).tolist(), "multi_ess": ess}
    print("cov:\n", np.round(stats["cov"], 3))
    print("cor:\n", np.round(stats["cor"], 3))
    print("iid mc_cov:\n", np.round(stats["iid_mc_cov"], 3))
    print("INSE mc_cov:\n", np.round(stats["inse_mc_cov"], 3))
    # AR(1): asymptotic variance = (1+rho)/(1-rho) * stationary variance
    print("analytic asymptotic var:", round((1 + rho) / (1 - rho), 3))
    print("mc_se:", np.round(stats["mc_se"], 3))
    print("multi_ess:", round(ess))
    print(f"ESS fraction (analytic (1-rho)/(1+rho) = {(1 - rho) / (1 + rho):.3f}):",
          round(ess / len(x), 3))

    rhat, imag, w, b, w_pd, b_pd = st.multi_rhat(chains)
    stats["multi_rhat"] = float(rhat)
    print(f"multi_rhat: {float(rhat):.4f} (W pd={w_pd}, B pd={b_pd})")

    cl = ChainLists.from_arrays({
        "sample": chains,
        "target_val": torch.zeros(chains.shape[:2], device=device),
        "accepted": torch.ones(chains.shape[:2], dtype=torch.int64, device=device),
    })
    summary = cl.summary(keys=("mean", "mc_se", "acceptance", "multi_ess", "multi_rhat"))
    stats["summary"] = {k: torch.as_tensor(v).tolist() for k, v in summary.items()}
    print("summary:", {k: np.round(v, 3) for k, v in stats["summary"].items()})
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(**vars(parser.parse_args()))
