"""Differential-evolution MCMC (ter Braak 2006) over a population.

Counterpart of ``eeyore_tpu/samplers/demc.py``: each walker i proposes
``theta_i + gamma (theta_a - theta_b) + scale z`` with a and b two distinct
other walkers, against the population as it stood at the start of the
iteration, and is accepted by a Metropolis test on the shared log target.
``gamma`` is ``c``, or ``2.38 / sqrt(2 P)`` when ``c`` is None. The partners
are exclusion-shifted ``torch.randint`` draws (exact, no rejection loop).
Run it with ``sample_population``.
"""

import math
from typing import NamedTuple

import torch

from eeyore_tpu_torch.samplers.population import PopulationKernel


class DEMCState(NamedTuple):
    sample: torch.Tensor      # [C, P]
    target_val: torch.Tensor  # [C]
    accepted: torch.Tensor    # [C] int32


def shift_partners(a, b):
    """Exclusion shift of raw draws ``a`` in [0, C-1) and ``b`` in [0, C-2)
    into partners a != i and b not in {i, a} for each walker i."""
    idx = torch.arange(a.shape[0], device=a.device)
    a = torch.where(a >= idx, a + 1, a)
    lo, hi = torch.minimum(idx, a), torch.maximum(idx, a)
    b = torch.where(b >= lo, b + 1, b)
    return a, torch.where(b >= hi, b + 1, b)


class DEMC(PopulationKernel):
    state_keys = ("sample", "target_val", "accepted")

    def __init__(self, model, c=None, scale=1e-3, recompute_current=False):
        super().__init__(model, recompute_current=recompute_current)
        self.c = c
        self.scale = scale

    def _gamma(self, num_params):
        return self.c if self.c is not None else 2.38 / math.sqrt(2.0 * num_params)

    def init(self, thetas, x, y, generator=None):
        thetas = torch.as_tensor(thetas)
        return DEMCState(sample=thetas, target_val=self.model.log_target(thetas, x, y),
                         accepted=torch.zeros(thetas.shape[0], dtype=torch.int32,
                                              device=thetas.device))

    def _partners(self, generator, num, device=None):
        """Two distinct partners a, b != i for each of ``num`` walkers."""
        a = torch.randint(0, num - 1, (num,), generator=generator, device=device)
        b = torch.randint(0, num - 2, (num,), generator=generator, device=device)
        return shift_partners(a, b)

    def step_fn(self, state, x, y, generator=None, partners=None, z=None, u=None):
        """One iteration of the population; the ``partners`` (a, b), the
        normals ``z [C, P]`` and the accept test's ``u [C]`` are drawn from
        ``generator`` unless given."""
        sample = state.sample
        num, P = sample.shape
        like = dict(dtype=sample.dtype, device=sample.device)
        current = (self.model.log_target(sample, x, y) if self.recompute_current
                   else state.target_val)
        a, b = partners if partners is not None else self._partners(generator, num,
                                                                    sample.device)
        if z is None:
            z = torch.randn(sample.shape, generator=generator, **like)
        if u is None:
            u = torch.rand(num, generator=generator, **like)
        proposal = sample + self._gamma(P) * (sample[a] - sample[b]) + self.scale * z
        proposed = self.model.log_target(proposal, x, y)
        accept = torch.log(u) < proposed - current
        new_state = DEMCState(sample=torch.where(accept[:, None], proposal, sample),
                              target_val=torch.where(accept, proposed, current),
                              accepted=accept.to(torch.int32))
        return new_state, new_state._asdict()

    def step(self, state, x, y, iteration=None, generator=None):
        return self.step_fn(state, x, y, generator=generator)
