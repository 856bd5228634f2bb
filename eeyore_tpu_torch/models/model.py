"""Model abstraction: tempered log-target functions over a flat theta.

Counterpart of ``eeyore_tpu/models/model.py``. Models are functions of
``theta [..., P]``, where leading dimensions are a batch of chains; they keep
no parameters of their own, so ``upto_grad_log_target`` is one
``torch.autograd.grad`` call. For Bayesian models the temperature multiplies
both the log-likelihood and the log-prior.
"""

import copy
import hashlib

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

    def summary(self, theta=None, hashsummary=False):
        """Print a model summary; with a theta, optionally the sha256
        checksums of its parameter groups (``hashsummary``)."""
        print(self)
        print("-" * 80)
        print(f"Number of model parameters: {self.num_params}")
        print("-" * 80)
        if getattr(self, "prior", None) is not None:
            print(f"Prior: {self.prior}")
            print("-" * 80)
        if hashsummary and theta is not None:
            print("Hash Summary:")
            for idx, hashvalue in enumerate(self.hashsummary(theta)):
                print(f"{idx}: {hashvalue}")

    def hashsummary(self, theta):
        """sha256 checksums of the flat theta's bytes on the host, one per
        parameter group when the model has ``unpack``, else one for the
        whole vector: the JAX package's bytes, so a theta of one dtype
        hashes the same in both."""
        theta = torch.as_tensor(theta).detach().cpu()
        if hasattr(self, "unpack"):
            chunks = []
            for w, b in self.unpack(theta):
                chunks.append(w)
                if b is not None:
                    chunks.append(b)
        else:
            chunks = [theta]
        return [hashlib.sha256(c.numpy().tobytes()).hexdigest() for c in chunks]

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

    def predictive_posterior(self, thetas, x, y):
        """Posterior-predictive Monte-Carlo integral of the likelihood of
        (x, y) over the samples ``thetas [S, P]``, NaN integrands dropped:
        (integral, num_dropped)."""
        from eeyore_tpu_torch.integrators import MCIntegrator

        return MCIntegrator(f=self.lik, samples=thetas).integrate(x, y)

    def predictive_posterior_from_dataset(self, thetas, dataset, num_points, generator=None,
                                          shuffle=True):
        """``predictive_posterior`` of ``num_points`` single points of the
        dataset: (integrals, indices, nums_dropped)."""
        from eeyore_tpu_torch.integrators import MCIntegrator

        return MCIntegrator(f=self.lik, samples=thetas).integrate_from_dataset(
            dataset, num_points, generator=generator, shuffle=shuffle)


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
