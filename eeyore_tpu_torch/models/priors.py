"""Priors over the flat parameter vector.

Counterpart of ``eeyore_tpu/models/priors.py``: a prior is any object with
``log_prob(theta) -> per-component log-densities``; the model sums them.
"""

import math

import torch


class IIDNormalPrior:
    """Independent Normal prior, one (loc, scale) pair per parameter."""

    def __init__(self, loc, scale, dtype=None, device="cuda"):
        self.loc = torch.as_tensor(loc, dtype=dtype, device=device)
        self.scale = torch.as_tensor(scale, dtype=self.loc.dtype, device=device)

    @classmethod
    def standard(cls, num_params, dtype=None, device="cuda"):
        dtype = dtype or torch.get_default_dtype()
        return cls(torch.zeros(num_params, dtype=dtype), torch.ones(num_params, dtype=dtype),
                   device=device)

    @classmethod
    def isotropic(cls, num_params, scale, dtype=None, device="cuda"):
        dtype = dtype or torch.get_default_dtype()
        return cls(torch.zeros(num_params, dtype=dtype),
                   torch.full((num_params,), float(scale), dtype=dtype), device=device)

    @property
    def dtype(self):
        return self.loc.dtype

    @property
    def device(self):
        return self.loc.device

    def log_prob(self, theta):
        z = (theta - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - 0.5 * math.log(2.0 * math.pi)

    def sample(self, generator=None, sample_shape=()):
        """One draw [P], or ``sample_shape + (P,)`` independent draws."""
        noise = torch.randn(tuple(sample_shape) + tuple(self.loc.shape), generator=generator,
                            dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + self.scale * noise
