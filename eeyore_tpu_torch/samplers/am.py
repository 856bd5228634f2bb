"""Haario's Adaptive Metropolis over a population of chains.

Counterpart of ``eeyore_tpu/samplers/am.py``. Once ``iteration + 1 -
offset`` exceeds ``t0``, a chain proposes from a mixture: with probability
``l`` an isotropic step ``c * z``, else ``b * chol(cov) @ z``, where ``cov``
is the chain's empirical covariance, kept from a running mean and a sum of
outer products: ``cov = (cov_sum - (k+1) m m') / max(k, 1)`` with ``k =
iteration - offset`` (am.py:91-109). A chain that has accepted nothing keeps
``cov0``; ``transform`` (e.g. ``stats.softabs``), given ``[C, P, P]``, makes
the estimate positive definite. Every chain carries its own ``[P, P]``
covariance, so a step holds two ``[C, P, P]`` tensors.

The Cholesky factor is ``torch.linalg.cholesky_ex`` of the symmetrised
covariance (JAX's ``cholesky`` symmetrises its input and returns NaNs where
it fails; PyTorch's reads the lower triangle and flags the failure in
``info``). A chain whose factor failed, or whose adapted step holds a NaN,
takes the isotropic step, as JAX masks it. Nothing here waits on the device:
the gates on the iteration are Python ints, the gates of each chain
``torch.where``s.
"""

from typing import NamedTuple

import numpy as np
import torch

from eeyore_tpu_torch.samplers.base import TransitionKernel
from eeyore_tpu_torch.stats.means import recursive_mean


class AMState(NamedTuple):
    sample: torch.Tensor        # [C, P]
    target_val: torch.Tensor    # [C]
    accepted: torch.Tensor      # [C] int32
    running_mean: torch.Tensor  # [C, P]
    cov_sum: torch.Tensor       # [C, P, P]
    cov: torch.Tensor           # [C, P, P]
    num_accepted: torch.Tensor  # [C] int32


def symmetric_cholesky(a):
    """(factor, failed [...]) of the symmetrised ``a [..., P, P]``: a chain
    fails where the factorisation does or leaves a NaN."""
    chol, info = torch.linalg.cholesky_ex((a + a.mT) / 2)
    return chol, (info != 0) | torch.isnan(chol).flatten(-2).any(-1)


class AM(TransitionKernel):
    state_keys = ("sample", "target_val", "accepted")
    needs_iteration = True

    def __init__(self, model, cov0=None, l=0.05, b=1.0, c=1.0, t0=2, transform=None,
                 offset=0, recompute_current=False):
        super().__init__(model, recompute_current=recompute_current)
        self.l = l
        self.b = b
        self.c = c
        self.t0 = t0
        self.transform = transform
        self.offset = offset
        self.cov0 = cov0

    def _cov0(self, num_params, like):
        if self.cov0 is None:
            cov0 = torch.eye(num_params, dtype=like.dtype, device=like.device)
        else:
            cov0 = torch.as_tensor(np.asarray(self.cov0) if not isinstance(self.cov0, torch.Tensor)
                                   else self.cov0).to(dtype=like.dtype, device=like.device)
        return cov0 if self.transform is None else self.transform(cov0)

    def init(self, thetas, x, y, generator=None):
        thetas = torch.as_tensor(thetas)
        C, P = thetas.shape
        zeros = torch.zeros(C, dtype=torch.int32, device=thetas.device)
        return AMState(sample=thetas, target_val=self.log_target(thetas, x, y), accepted=zeros,
                       running_mean=torch.zeros_like(thetas),
                       cov_sum=thetas.new_zeros((C, P, P)),
                       cov=self._cov0(P, thetas).expand(C, P, P).clone(), num_accepted=zeros)

    def step_fn(self, state, x, y, iteration, generator=None, z=None, u_mix=None, u_acc=None):
        """One transition of every chain at ``iteration`` (a Python int);
        the normals ``z [C, P]``, the mixture's ``u_mix [C]`` and the accept
        test's ``u_acc [C]`` are drawn from ``generator`` unless given."""
        sample = state.sample
        C, P = sample.shape
        like = dict(dtype=sample.dtype, device=sample.device)
        current = (self.log_target(sample, x, y) if self.recompute_current
                   else state.target_val)
        if z is None:
            z = torch.randn(sample.shape, generator=generator, **like)
        if u_mix is None:
            u_mix = torch.rand(C, generator=generator, **like)
        if u_acc is None:
            u_acc = torch.rand(C, generator=generator, **like)
        step = self.c * z
        if iteration + 1 - self.offset > self.t0:
            chol, failed = symmetric_cholesky(state.cov)
            adapted = self.b * (chol @ z[:, :, None])[..., 0]
            failed = failed | torch.isnan(adapted).any(-1)
            step = torch.where(((u_mix >= self.l) & ~failed)[:, None], adapted, step)
        proposal = sample + step
        proposed = self.log_target(proposal, x, y)
        accept = torch.log(u_acc) < proposed - current
        new_sample = torch.where(accept[:, None], proposal, sample)
        num_accepted = state.num_accepted
        if iteration > 0:
            num_accepted = num_accepted + accept.to(torch.int32)

        # the covariance's adaptation (am.py:91-109)
        new_mean = recursive_mean(state.running_mean, iteration + 1, new_sample,
                                  offset=self.offset)
        cov_sum = state.cov_sum + new_sample[:, :, None] * new_sample[:, None, :]
        cov = state.cov
        if iteration + 1 - self.offset >= self.t0:
            k = float(iteration - self.offset)
            est = (cov_sum - (k + 1.0) * (new_mean[:, :, None] * new_mean[:, None, :])) \
                / max(k, 1.0)
            if self.transform is not None:
                est = self.transform(est)
            cov = torch.where((num_accepted == 0)[:, None, None], self._cov0(P, sample), est)
        new_state = AMState(sample=new_sample, target_val=torch.where(accept, proposed, current),
                            accepted=accept.to(torch.int32), running_mean=new_mean,
                            cov_sum=cov_sum, cov=cov, num_accepted=num_accepted)
        return new_state, {k_: getattr(new_state, k_) for k_ in self.state_keys}

    def step(self, state, x, y, iteration, generator=None):
        return self.step_fn(state, x, y, iteration, generator=generator)
