"""Multivariate potential scale reduction factor, in float64 PyTorch.

Counterpart of ``eeyore_tpu/stats/rhat.py``: Brooks-Gelman PSRF over an
[m, n, p] stack of chains, with W the mean per-chain Monte-Carlo covariance,
B the covariance of the chain means and

    Rhat = (n - 1)/n + (m + 1)/m * lambda_max(W^{-1} B),

a nearest-PD projection of W or B where either is not PD, and the same
6-tuple return.
"""

import torch

from eeyore_tpu_torch.linalg import is_pos_def, nearest_pd
from eeyore_tpu_torch.stats.cov import cov
from eeyore_tpu_torch.stats.mc_cov import mc_cov


def _pd_or_project(mat):
    """(mat, True) when PD, else (nearest-PD projection, False)."""
    if is_pos_def(mat):
        return mat, True
    return nearest_pd(mat), False


def multi_rhat(x, mc_cov_mat=None, method="inse", adjust=False):
    draws = torch.as_tensor(x, dtype=torch.float64)
    m, n, _ = draws.shape

    if mc_cov_mat is None:
        per_chain = [mc_cov(draws[c], method=method, adjust=adjust, rowvar=False)
                     for c in range(m)]
    else:
        per_chain = [torch.as_tensor(s, dtype=torch.float64) for s in mc_cov_mat]
    w, w_was_pd = _pd_or_project(torch.stack(per_chain).mean(dim=0))
    b, b_was_pd = _pd_or_project(torch.atleast_2d(cov(draws.mean(dim=1), rowvar=False)))

    lam = torch.linalg.eigvals(torch.linalg.solve(w, b))
    top = int(torch.argmax(lam.real))
    psrf = (n - 1.0) / n + (m + 1.0) / m * float(lam.real[top])

    return psrf, float(lam.imag[top]), w, b, w_was_pd, b_was_pd
