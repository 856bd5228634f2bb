"""Sample covariance and correlation, in float64 PyTorch.

Counterpart of ``eeyore_tpu/stats/cov.py`` (unbiased, n - 1 denominator).
"""

import torch


def cov(x, rowvar=False):
    """Unbiased sample covariance. x: [n, p] when rowvar=False."""
    x = torch.as_tensor(x, dtype=torch.float64)
    if x.dim() > 2:
        raise ValueError("x has more than 2 dimensions")
    if x.dim() < 2:
        x = x.reshape(1, -1)
    if not rowvar and x.shape[0] != 1:
        x = x.T
    x_ctr = x - x.mean(dim=1, keepdim=True)
    return torch.squeeze(x_ctr @ x_ctr.T) / (x.shape[1] - 1)


def cor_from_cov(cov_mat):
    cov_mat = torch.as_tensor(cov_mat, dtype=torch.float64)
    inv_sd = 1.0 / torch.sqrt(torch.diag(cov_mat))
    return cov_mat * torch.outer(inv_sd, inv_sd)


def cor(x, rowvar=False):
    return cor_from_cov(cov(x, rowvar=rowvar))
