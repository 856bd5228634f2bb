"""Hamiltonian Monte Carlo over a population of chains, with leapfrog
integration and optional per-chain dual-averaging step-size tuning.

Counterpart of ``eeyore_tpu/samplers/hmc.py``: identity mass matrix, leapfrog
with half steps at both ends and the momentum negated, acceptance
min(1, exp(H_cur - H_prop)), the NUTS Algorithm-4 initial-step heuristic,
and per-burn-in-iteration (step, num_steps) updates from the tuner. Where the
JAX package vmaps one chain, every tensor here carries the chains as its
first dimension and each chain keeps its own step, trajectory length and
tuner state. The leapfrog runs to the longest trajectory of the batch and
holds finished chains where they stopped, so it reads that length to the
host once per call.
"""

from typing import NamedTuple

import torch

from eeyore_tpu_torch.samplers.base import TransitionKernel
from eeyore_tpu_torch.tuners.dual_averaging import DualAveragingState, HMCDATuner


class HMCState(NamedTuple):
    sample: torch.Tensor       # [C, P]
    target_val: torch.Tensor   # [C]
    grad_val: torch.Tensor     # [C, P]
    momentum: torch.Tensor     # [C, P] starting momentum of the last trajectory
    hamiltonian: torch.Tensor  # [C] starting Hamiltonian of the last trajectory
    accepted: torch.Tensor     # [C] int32
    step: torch.Tensor         # [C] current leapfrog step (tuner-dynamic)
    num_steps: torch.Tensor    # [C] int32 current trajectory length (tuner-dynamic)
    tuner: DualAveragingState  # fields [C]


def _per_chain(value, like):
    """``value`` (a number or a [C] tensor) as a [C] tensor in ``like``'s
    dtype and device."""
    value = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    return value.expand(like.shape[0]) if value.dim() == 0 else value


class HMC(TransitionKernel):
    state_keys = ("sample", "target_val", "grad_val", "momentum", "hamiltonian", "accepted")

    def __init__(self, model, step=0.1, num_steps=10, tuner=None, max_num_steps=None,
                 num_burnin_iters=0, recompute_current=False, l_rounding="round"):
        super().__init__(model, recompute_current=recompute_current)
        self.step0 = step
        self.num_steps0 = num_steps
        # how the kernel backend freezes the l-rule trajectory length at
        # burn-in end ('round' or per-chain 'stochastic'); the generic path
        # tunes per chain and re-rounds every iteration, so only the kernel
        # reads it
        if l_rounding not in ("round", "stochastic"):
            raise ValueError(f"l_rounding must be 'round' or 'stochastic', "
                             f"got {l_rounding!r}")
        self.l_rounding = l_rounding
        if tuner is not None and tuner.l is None and type(self) is HMC:
            raise ValueError(
                "HMC's dual-averaging tuner needs a target trajectory length: "
                "pass HMCDATuner(l=...) (num_steps = round(l / step)); only "
                "NUTS, which picks its own trajectories, can omit l")
        self.tuner = tuner
        # None = the generic default ceiling 1024; kernel dispatch treats an
        # explicit ceiling above its cap as ineligible but caps the default
        self.explicit_max_num_steps = max_num_steps is not None
        self.max_num_steps = 1024 if max_num_steps is None else max_num_steps
        # tuning runs while iteration < num_burnin_iters; the runner sets it
        self.num_burnin_iters = num_burnin_iters

    # ---- Hamiltonian pieces ----

    def kinetic_energy(self, momentum):
        return 0.5 * torch.sum(momentum * momentum, dim=-1)

    def hamiltonian(self, potential, momentum):
        return potential + self.kinetic_energy(momentum)

    # ---- leapfrog ----

    def leapfrog(self, position, momentum, grad, step, num_steps, x, y):
        """Leapfrog trajectories of every chain. ``grad`` is the gradient of
        the log target at ``position``; ``step`` and ``num_steps`` are numbers
        or [C] tensors. Each chain takes its own ``num_steps``; the batch runs
        to the largest and the others stay where they stopped.

        Returns (position, momentum (negated), target_val, grad_val); a chain
        with ``num_steps == 0`` returns target_val 0, as the JAX package's
        while loop does."""
        step = _per_chain(step, position[:, 0])[:, None]
        num_steps = torch.as_tensor(num_steps, device=position.device)
        num_steps = num_steps.expand(position.shape[0]) if num_steps.dim() == 0 else num_steps
        momentum = momentum + 0.5 * step * grad
        target = torch.zeros_like(position[:, 0])
        for i in range(int(num_steps.max()) if position.shape[0] else 0):
            active = (i < num_steps)[:, None]
            pos_i = position + step * momentum
            tgt_i, grd_i = self.upto_grad_log_target(pos_i, x, y)
            factor = torch.where(num_steps - 1 == i, 0.5, 1.0).to(step.dtype)[:, None]
            mom_i = momentum + factor * step * grd_i
            position = torch.where(active, pos_i, position)
            momentum = torch.where(active, mom_i, momentum)
            target = torch.where(active[:, 0], tgt_i, target)
            grad = torch.where(active, grd_i, grad)
        return position, -momentum, target, grad

    def init(self, thetas, x, y, generator=None):
        """State of every chain at ``thetas [C, P]``. A tuner without ``e0``
        starts each chain at its ``find_initial_step``, with momenta from
        ``generator``, when one is given, and at ``step`` otherwise (as the
        JAX package's init without a key)."""
        thetas = torch.as_tensor(thetas)
        target, grad = self.upto_grad_log_target(thetas, x, y)
        like = thetas[:, 0]

        step = _per_chain(self.step0, like)
        num_steps = torch.full_like(like, self.num_steps0, dtype=torch.int32)
        if self.tuner is not None:
            if self.tuner.e0 is not None:
                step = _per_chain(self.tuner.e0, like)
            elif generator is not None:
                sched = getattr(self, "init_schedule", None)
                if sched is not None and sched.num_batches == 1:
                    sched = None
                step = self.find_initial_step(thetas, x, y, generator=generator,
                                              schedule=sched)
                if self.tuner.eub is not None:
                    step = torch.clamp(step, max=self.tuner.eub)
            tuner_state = self.tuner.init(step, dtype=thetas.dtype, device=thetas.device)
            num_steps = self.tuner.num_steps(step)
        else:
            tuner_state = HMCDATuner(l=1.0).init(step, dtype=thetas.dtype,
                                                  device=thetas.device)  # inert placeholder

        return HMCState(
            sample=thetas,
            target_val=target,
            grad_val=grad,
            momentum=torch.zeros_like(thetas),
            hamiltonian=torch.zeros_like(like),
            accepted=torch.zeros_like(like, dtype=torch.int32),
            step=step.clone(),
            num_steps=num_steps,
            tuner=tuner_state,
        )

    def find_initial_step(self, thetas, x, y, momenta=None, generator=None,
                          max_doublings=100, schedule=None):
        """NUTS Algorithm-4 heuristic, per chain: from step 1, scale by 2^a
        (a = +-1 fixed by the first acceptance ratio) until the one-step
        acceptance ratio crosses 1/2. ``momenta [C, P]`` are drawn from
        ``generator`` unless given. Chains that have crossed stop doubling;
        the loop runs until every chain has. With a minibatch ``schedule``,
        each doubling moves to the next batch, as the JAX package does."""
        thetas = torch.as_tensor(thetas)
        if momenta is None:
            momenta = torch.randn(thetas.shape, generator=generator, dtype=thetas.dtype,
                                  device=thetas.device)

        def ratio_for(step, batch_idx):
            xb, yb = (x, y) if schedule is None else schedule.batch(batch_idx)
            target0, grad0 = self.upto_grad_log_target(thetas, xb, yb)
            h0 = self.hamiltonian(-target0, momenta)
            _, mom, tgt, _ = self.leapfrog(thetas, momenta, grad0, step, 1, xb, yb)
            h1 = self.hamiltonian(-tgt, mom)
            return torch.exp(h0 - h1)

        num_batches = 1 if schedule is None else schedule.num_batches
        step = torch.ones_like(thetas[:, 0])
        ratio = ratio_for(step, 0)
        a = torch.where(ratio > 0.5, 1.0, -1.0).to(thetas.dtype)
        doublings = 0
        active = (ratio ** a > 2.0 ** (-a)) & (doublings < max_doublings)
        while bool(active.any()):
            step = torch.where(active, step * 2.0 ** a, step)
            ratio = torch.where(active, ratio_for(step, (doublings + 1) % num_batches), ratio)
            doublings += 1
            active = active & (ratio ** a > 2.0 ** (-a)) & (doublings < max_doublings)
        return step

    def step_fn(self, state, x, y, iteration, generator=None, momenta=None, uniforms=None):
        """One transition of every chain at global iteration ``iteration``.
        ``momenta [C, P]`` and ``uniforms [C]`` are drawn from ``generator``
        unless given."""
        dtype = state.sample.dtype
        if self.recompute_current:
            current_target, current_grad = self.upto_grad_log_target(state.sample, x, y)
        else:
            current_target, current_grad = state.target_val, state.grad_val

        if momenta is None:
            momenta = torch.randn(state.sample.shape, generator=generator, dtype=dtype,
                                  device=state.sample.device)
        h_current = self.hamiltonian(-current_target, momenta)

        num_steps = torch.clamp(state.num_steps, max=self.max_num_steps)
        pos, mom, target, grad = self.leapfrog(state.sample, momenta, current_grad,
                                               state.step, num_steps, x, y)
        h_proposed = self.hamiltonian(-target, mom)

        rate = torch.clamp(torch.exp(h_current - h_proposed), max=1.0)
        if uniforms is None:
            uniforms = torch.rand(rate.shape, generator=generator, dtype=dtype,
                                  device=rate.device)
        accept = uniforms < rate

        new_sample = torch.where(accept[:, None], pos, state.sample)
        new_target = torch.where(accept, target, current_target)
        new_grad = torch.where(accept[:, None], grad, current_grad)

        # dual averaging during burn-in; the last burn-in iteration switches
        # to the averaged step
        new_tuner, new_step, new_num_steps = state.tuner, state.step, state.num_steps
        if self.tuner is not None and iteration < self.num_burnin_iters:
            return_e = iteration != self.num_burnin_iters - 1
            new_tuner, new_step, new_num_steps = self.tuner.tune(state.tuner, rate, iteration,
                                                                 return_e)

        new_state = HMCState(
            sample=new_sample,
            target_val=new_target,
            grad_val=new_grad,
            momentum=momenta,
            hamiltonian=h_current,
            accepted=accept.to(torch.int32),
            step=new_step,
            num_steps=new_num_steps,
            tuner=new_tuner,
        )
        info = {k: getattr(new_state, k) for k in self.state_keys}
        return new_state, info

    def step(self, state, x, y, iteration, generator=None):
        return self.step_fn(state, x, y, iteration, generator=generator)
