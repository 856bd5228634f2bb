"""Proposal (probability-density) kernels for the MCMC samplers.

Counterpart of ``eeyore_tpu/kernels/proposal_kernels.py``. The kernels are
stateless: the location is an argument, and every function is batched over
leading dimensions, so one kernel serves a ``[C, P]`` population of chains.
``log_prob`` sums over the last dimension (one value per chain); ``sample``
draws from a ``torch.Generator`` on the location's device. The kernels'
parameters are kept as given and moved to the location's dtype and device
at each call.
"""

import math

import numpy as np
import torch


def _param(value):
    """A kernel parameter as a tensor; numbers and arrays in float64, so no
    precision is lost before the location's dtype is known."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value, dtype=np.float64))


def _like(value, ref):
    return torch.as_tensor(value).to(dtype=ref.dtype, device=ref.device)


def _normal(loc, generator):
    return torch.randn(loc.shape, generator=generator, dtype=loc.dtype, device=loc.device)


class NormalKernel:
    """iid Normal proposal of fixed scale (a number, or one per coordinate)."""

    def __init__(self, scale):
        self.scale = _param(scale)

    def sample(self, generator, loc):
        return loc + _like(self.scale, loc) * _normal(loc, generator)

    def log_prob(self, x, loc):
        scale = _like(self.scale, loc)
        z = (x - loc) / scale
        per = -0.5 * z * z - torch.log(scale) - 0.5 * math.log(2.0 * math.pi)
        return torch.sum(per, dim=-1)


class MultivariateNormalKernel:
    """Multivariate Normal proposal with covariance ``L L^T``, from its
    lower-triangular ``scale_tril`` L."""

    def __init__(self, scale_tril):
        self.scale_tril = _param(scale_tril)

    def sample(self, generator, loc):
        z = _normal(loc, generator)
        return loc + z @ _like(self.scale_tril, loc).T

    def log_prob(self, x, loc):
        tril = _like(self.scale_tril, loc)
        diff = x - loc
        z = torch.linalg.solve_triangular(tril, diff.unsqueeze(-1), upper=False).squeeze(-1)
        half_log_det = torch.sum(torch.log(torch.diagonal(tril)))
        d = diff.shape[-1]
        return -0.5 * torch.sum(z * z, dim=-1) - half_log_det - 0.5 * d * math.log(2.0 * math.pi)


class DEMCKernel:
    """Differential-evolution proposal: Normal of ``scale`` around ``theta +
    c * (a - b)``, with a and b two other members of the population."""

    def __init__(self, c=0.1, scale=1e-3):
        self.c = c
        self.scale = _param(scale)

    def mean(self, theta, a, b):
        return theta + self.c * (a - b)

    def sample(self, generator, theta, a, b):
        loc = self.mean(theta, a, b)
        return loc + _like(self.scale, loc) * _normal(loc, generator)

    def log_prob(self, x, theta, a, b):
        return NormalKernel(self.scale).log_prob(x, self.mean(theta, a, b))
