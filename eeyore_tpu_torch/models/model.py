"""Model abstraction: tempered log-target functions over a flat theta.

Counterpart of ``eeyore_tpu/models/model.py``. Models are functions of
``theta [..., P]``, where leading dimensions are a batch of chains; they keep
no parameters of their own, so ``upto_grad_log_target`` is one
``torch.autograd.grad`` call. For Bayesian models the temperature multiplies
both the log-likelihood and the log-prior.
"""

import copy

import torch


class LogTargetModel:
    """Base: anything with a tempered ``log_target(theta, x, y)``."""

    temperature = None
    num_params = None

    def log_target(self, theta, x, y):
        raise NotImplementedError

    def upto_grad_log_target(self, theta, x, y):
        """(log_target, grad) in one pass. ``theta`` may carry leading batch
        dimensions; each entry's gradient is its own, since the entries of
        a batch do not interact."""
        with torch.enable_grad():
            theta = theta.detach().requires_grad_(True)
            val = self.log_target(theta, x, y)
            (grad,) = torch.autograd.grad(val.sum(), theta)
        return val.detach(), grad

    def with_temperature(self, temperature):
        """Shallow copy with a different temperature."""
        new = copy.copy(self)
        new.temperature = temperature
        return new

    def _temper(self, val):
        if self.temperature is None:
            return val
        return self.temperature * val


class BayesianModel(LogTargetModel):
    """log-posterior = temperature * (log_lik + log_prior).

    Subclasses provide ``forward(theta, x)`` and set ``loss``, ``prior`` and
    ``num_params``.
    """

    def __init__(self, loss, prior=None, temperature=None, dtype=None, device="cuda"):
        self.loss = loss
        self.prior = prior
        self.temperature = temperature
        self.dtype = dtype or torch.get_default_dtype()
        self.device = torch.device(device)

    def forward(self, theta, x):
        raise NotImplementedError

    def log_lik(self, theta, x, y):
        return self._temper(-self.loss(self.forward(theta, x), y))

    def log_prior(self, theta):
        return self._temper(torch.sum(self.prior.log_prob(theta), dim=-1))

    def log_target(self, theta, x, y):
        return self.log_lik(theta, x, y) + self.log_prior(theta)

    def lik(self, theta, x, y):
        return torch.exp(self.log_lik(theta, x, y))

    def sample_prior(self, generator=None):
        return self.prior.sample(generator)


class DistributionModel(LogTargetModel):
    """Wraps an arbitrary ``log_pdf(theta, x, y)`` closure as a sampleable
    model; ``log_pdf`` takes ``theta [..., P]`` and returns ``[...]``, as the
    port's models do. The temperature multiplies the log-pdf."""

    def __init__(self, log_pdf, num_params, temperature=None, dtype=None, device="cuda"):
        self.log_pdf = log_pdf
        self.num_params = num_params
        self.temperature = temperature
        self.dtype = dtype or torch.get_default_dtype()
        self.device = torch.device(device)

    def log_target(self, theta, x, y):
        return self._temper(self.log_pdf(theta, x, y))
