"""Metropolis-adjusted Langevin (MALA) over a population of chains.

Counterpart of ``eeyore_tpu/samplers/mala.py``: the proposal mean is
``theta + step/2 * grad``, the proposal an iid Normal of scale sqrt(step)
around it, and the full asymmetric Hastings correction uses the reverse
kernel centred at the proposal's drift (mala.py:59-74); a proposal is
accepted when log(u) < log_rate. One value-and-gradient evaluation per
proposal.
"""

import math
from typing import NamedTuple

import torch

from eeyore_tpu_torch.samplers.base import TransitionKernel


class MALAState(NamedTuple):
    sample: torch.Tensor      # [C, P]
    target_val: torch.Tensor  # [C]
    grad_val: torch.Tensor    # [C, P]
    accepted: torch.Tensor    # [C] int32


class MALA(TransitionKernel):
    state_keys = ("sample", "target_val", "grad_val", "accepted")

    def __init__(self, model, step=0.1, recompute_current=False):
        super().__init__(model, recompute_current=recompute_current)
        self.step_size = step

    def kernel_mean(self, sample, grad):
        return sample + 0.5 * self.step_size * grad

    def _normal_log_prob(self, x, loc):
        """log N(x; loc, step I), summed over the last dimension."""
        scale = math.sqrt(self.step_size)
        z = (x - loc) / scale
        return torch.sum(-0.5 * z * z - math.log(scale) - 0.5 * math.log(2.0 * math.pi), dim=-1)

    def init(self, thetas, x, y, generator=None):
        thetas = torch.as_tensor(thetas)
        target, grad = self.upto_grad_log_target(thetas, x, y)
        return MALAState(sample=thetas, target_val=target, grad_val=grad,
                         accepted=torch.zeros(thetas.shape[0], dtype=torch.int32,
                                              device=thetas.device))

    def step_fn(self, state, x, y, generator=None, noise=None, uniforms=None):
        """One transition of every chain; the standard normals ``noise [C,
        P]`` and ``uniforms [C]`` are drawn from ``generator`` unless given."""
        if self.recompute_current:
            current, current_grad = self.upto_grad_log_target(state.sample, x, y)
        else:
            current, current_grad = state.target_val, state.grad_val
        fwd_mean = self.kernel_mean(state.sample, current_grad)
        if noise is None:
            noise = torch.randn(state.sample.shape, generator=generator,
                                dtype=state.sample.dtype, device=state.sample.device)
        proposal = fwd_mean + math.sqrt(self.step_size) * noise
        proposed, proposed_grad = self.upto_grad_log_target(proposal, x, y)
        rev_mean = self.kernel_mean(proposal, proposed_grad)
        log_rate = (proposed - current - self._normal_log_prob(proposal, fwd_mean)
                    + self._normal_log_prob(state.sample, rev_mean))
        if uniforms is None:
            uniforms = torch.rand(log_rate.shape, generator=generator, dtype=log_rate.dtype,
                                  device=log_rate.device)
        accept = torch.log(uniforms) < log_rate
        new_state = MALAState(sample=torch.where(accept[:, None], proposal, state.sample),
                              target_val=torch.where(accept, proposed, current),
                              grad_val=torch.where(accept[:, None], proposed_grad, current_grad),
                              accepted=accept.to(torch.int32))
        return new_state, new_state._asdict()

    def step(self, state, x, y, iteration=None, generator=None):
        return self.step_fn(state, x, y, generator=generator)
