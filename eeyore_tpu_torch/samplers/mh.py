"""Random-walk Metropolis-Hastings over a population of chains.

Counterpart of ``eeyore_tpu/samplers/mh.py``: the default proposal is an iid
Normal of unit scale centred at the current state; the asymmetric mode
subtracts the forward and adds the reverse proposal log-density (mh.py:51-54);
a proposal is accepted when log(u) < log_rate. Every tensor carries the
chains as its first dimension.
"""

from typing import NamedTuple

import torch

from eeyore_tpu_torch.kernels import NormalKernel
from eeyore_tpu_torch.samplers.base import TransitionKernel


class MHState(NamedTuple):
    sample: torch.Tensor      # [C, P]
    target_val: torch.Tensor  # [C]
    accepted: torch.Tensor    # [C] int32


class MetropolisHastings(TransitionKernel):
    state_keys = ("sample", "target_val", "accepted")

    def __init__(self, model, symmetric=True, kernel=None, scale=1.0, recompute_current=False):
        super().__init__(model, recompute_current=recompute_current)
        self.symmetric = symmetric
        self.kernel = kernel or NormalKernel(scale)

    def init(self, thetas, x, y, generator=None):
        thetas = torch.as_tensor(thetas)
        return MHState(sample=thetas, target_val=self.log_target(thetas, x, y),
                       accepted=torch.zeros(thetas.shape[0], dtype=torch.int32,
                                            device=thetas.device))

    def step_fn(self, state, x, y, generator=None, proposal=None, uniforms=None):
        """One transition of every chain; ``proposal [C, P]`` and ``uniforms
        [C]`` are drawn from ``generator`` unless given."""
        current = (self.log_target(state.sample, x, y) if self.recompute_current
                   else state.target_val)
        if proposal is None:
            proposal = self.kernel.sample(generator, state.sample)
        proposed = self.log_target(proposal, x, y)
        log_rate = proposed - current
        if not self.symmetric:
            log_rate = log_rate - self.kernel.log_prob(proposal, state.sample)
            log_rate = log_rate + self.kernel.log_prob(state.sample, proposal)
        if uniforms is None:
            uniforms = torch.rand(log_rate.shape, generator=generator, dtype=log_rate.dtype,
                                  device=log_rate.device)
        accept = torch.log(uniforms) < log_rate
        new_state = MHState(sample=torch.where(accept[:, None], proposal, state.sample),
                            target_val=torch.where(accept, proposed, current),
                            accepted=accept.to(torch.int32))
        return new_state, new_state._asdict()

    def step(self, state, x, y, iteration=None, generator=None):
        return self.step_fn(state, x, y, generator=generator)
