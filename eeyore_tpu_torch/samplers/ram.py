"""Vihola's Robust Adaptive Metropolis over a population of chains.

Counterpart of ``eeyore_tpu/samplers/ram.py``. Each chain proposes ``theta
+ L z`` with its own Cholesky factor ``L [P, P]``; after every step the
factor becomes ``chol(L (I + h (rate - a) z z' / z'z) L')`` with ``h =
min(1, P it^-g)``, ``it = iteration + 1 - offset`` and ``rate = min(1,
exp(log_rate))``, which steers the acceptance towards ``a`` (ram.py:59-69).

The new factor is ``torch.linalg.cholesky_ex`` of the symmetrised product
(JAX's ``cholesky`` symmetrises; ``L M L'`` is not exactly symmetric in
floating point). A chain whose factorisation fails or leaves a NaN keeps its
old factor, as JAX's NaN mask does. The gate on the iteration is a Python
number, so no step waits on the device.
"""

from typing import NamedTuple

import numpy as np
import torch

from eeyore_tpu_torch.samplers.am import symmetric_cholesky
from eeyore_tpu_torch.samplers.base import TransitionKernel


class RAMState(NamedTuple):
    sample: torch.Tensor      # [C, P]
    target_val: torch.Tensor  # [C]
    accepted: torch.Tensor    # [C] int32
    chol_cov: torch.Tensor    # [C, P, P]


def adaptation_weight(iteration, offset, g, num_params):
    """``h = min(1, P it^-g)`` at ``it = iteration + 1 - offset``, as JAX
    computes it in floating point: 1 at it = 0 (its power is inf), NaN below
    (a negative base to a fractional power), which leaves the factor as
    it is."""
    it = iteration + 1 - offset
    if it < 0:
        return float("nan")
    if it == 0:
        return 1.0
    return min(1.0, num_params * float(it) ** (-g))


class RAM(TransitionKernel):
    state_keys = ("sample", "target_val", "accepted")
    needs_iteration = True

    def __init__(self, model, cov0=None, a=0.234, g=0.7, offset=0, recompute_current=False):
        super().__init__(model, recompute_current=recompute_current)
        self.a = a
        self.g = g
        self.offset = offset
        self.cov0 = cov0

    def init(self, thetas, x, y, generator=None):
        thetas = torch.as_tensor(thetas)
        C, P = thetas.shape
        like = dict(dtype=thetas.dtype, device=thetas.device)
        if self.cov0 is None:
            cov0 = torch.eye(P, **like)
        else:
            cov0 = torch.as_tensor(np.asarray(self.cov0) if not isinstance(self.cov0, torch.Tensor)
                                   else self.cov0).to(**like)
        chol, failed = symmetric_cholesky(cov0)
        chol = torch.where(failed, torch.nan, chol)  # JAX's factor of a non-PD cov0
        return RAMState(sample=thetas, target_val=self.log_target(thetas, x, y),
                        accepted=torch.zeros(C, dtype=torch.int32, device=thetas.device),
                        chol_cov=chol.expand(C, P, P).clone())

    def step_fn(self, state, x, y, iteration, generator=None, z=None, u_acc=None):
        """One transition of every chain at ``iteration`` (a Python int);
        the normals ``z [C, P]`` and the accept test's ``u_acc [C]`` are
        drawn from ``generator`` unless given."""
        sample, chol = state.sample, state.chol_cov
        C, P = sample.shape
        like = dict(dtype=sample.dtype, device=sample.device)
        current = (self.log_target(sample, x, y) if self.recompute_current
                   else state.target_val)
        if z is None:
            z = torch.randn(sample.shape, generator=generator, **like)
        if u_acc is None:
            u_acc = torch.rand(C, generator=generator, **like)
        proposal = sample + (chol @ z[:, :, None])[..., 0]
        proposed = self.log_target(proposal, x, y)
        log_rate = proposed - current
        accept = torch.log(u_acc) < log_rate

        # the factor's rank-1 adaptation (ram.py:59-69)
        h = adaptation_weight(iteration, self.offset, self.g, P)
        rate = torch.minimum(torch.exp(log_rate), torch.ones((), **like))
        coef = h * (rate - self.a)
        middle = torch.eye(P, **like) + coef[:, None, None] * (z[:, :, None] * z[:, None, :]) \
            / torch.sum(z * z, dim=-1)[:, None, None]
        new_chol, failed = symmetric_cholesky(chol @ middle @ chol.mT)
        new_state = RAMState(sample=torch.where(accept[:, None], proposal, sample),
                             target_val=torch.where(accept, proposed, current),
                             accepted=accept.to(torch.int32),
                             chol_cov=torch.where(failed[:, None, None], chol, new_chol))
        return new_state, {k: getattr(new_state, k) for k in self.state_keys}

    def step(self, state, x, y, iteration, generator=None):
        return self.step_fn(state, x, y, iteration, generator=generator)
