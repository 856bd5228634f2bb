"""Multivariate effective sample size, in log-determinant space.

Counterpart of ``eeyore_tpu/stats/ess.py``: ESS = n * (|S| / |M|)^(1/p)
with S the sample covariance and M the Monte-Carlo covariance of the chain,
through ``slogdet`` so that it stays finite when the determinants would
under- or overflow float64.
"""

import math

import torch

from eeyore_tpu_torch.stats.cov import cov
from eeyore_tpu_torch.stats.mc_cov import mc_cov


def multi_ess(x, mc_cov_mat=None, method="inse", adjust=False):
    draws = torch.as_tensor(x, dtype=torch.float64)
    n, p = draws.shape

    if mc_cov_mat is None:
        mc_cov_mat = mc_cov(draws, method=method, adjust=adjust, rowvar=False)

    s_sign, s_logdet = torch.linalg.slogdet(cov(draws, rowvar=False))
    m_sign, m_logdet = torch.linalg.slogdet(torch.as_tensor(mc_cov_mat, dtype=torch.float64))
    s_sign, s_logdet, m_sign, m_logdet = (float(v) for v in (s_sign, s_logdet, m_sign,
                                                             m_logdet))

    if s_sign <= 0 or m_sign <= 0:
        # a covariance estimate that is not PD: the raw-ratio arithmetic
        # (nan for a negative ratio at a fractional power)
        ratio = (s_sign * math.exp(s_logdet)) / (m_sign * math.exp(m_logdet))
        return float(n * torch.pow(torch.tensor(ratio, dtype=torch.float64), 1.0 / p))
    return float(n * math.exp((s_logdet - m_logdet) / p))
