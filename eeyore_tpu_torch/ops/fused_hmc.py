"""Batch-fused HMC: the whole chain population stepped as [C, P] tensors,
with the fused value-and-gradient kernel in the leapfrog loop.

Counterpart of ``eeyore_tpu/ops/fused_hmc.py``:
- one launch of ``fused_mlp_vg`` per leapfrog step evaluates the
  log-posterior and its gradient for all chains (ops/fused_mlp.py);
- one step size is adapted by dual averaging on the population-mean
  acceptance rate, so every chain runs the same number of leapfrog steps;
- samples are recorded as [kept, C, ...] tensors.

The momenta and the accept uniforms come from a ``torch.Generator`` seeded by
``run``; ``leapfrog`` and ``step_fn`` also take them as arguments. The
number of leapfrog steps drives a host loop, so a tuned iteration reads it
back from the device once (one host sync per iteration).
"""

from typing import NamedTuple

import numpy as np
import torch

from eeyore_tpu_torch.ops.fused_mlp import make_fused_log_target_vg
from eeyore_tpu_torch.tuners.dual_averaging import DualAveragingState, HMCDATuner


class FusedHMCState(NamedTuple):
    thetas: torch.Tensor       # [C, P]
    target_vals: torch.Tensor  # [C]
    grads: torch.Tensor        # [C, P]
    step: torch.Tensor         # 0-d float32
    num_steps: torch.Tensor    # 0-d int32
    tuner: DualAveragingState


# Recordable keys of ``step_fn``'s info: (shape after [C], dtype).
RECORDABLE = {
    "sample": (("P",), torch.float32),
    "target_val": ((), torch.float32),
    "accepted": ((), torch.int32),
    "rate": ((), torch.float32),
}


class FusedHMC:
    def __init__(self, model, x, y, step=0.1, num_steps=10, tuner=None, max_num_steps=1024,
                 device="cuda", use_fused_kernel=True):
        self.model = model
        self.device = torch.device(device)
        self.x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)
        self.y = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=self.device)
        self.step0 = step
        self.num_steps0 = num_steps
        self.tuner = tuner
        self.max_num_steps = max_num_steps
        if use_fused_kernel:
            self.vg = make_fused_log_target_vg(model, np.asarray(x), np.asarray(y),
                                               device=self.device)
        else:
            self.vg = self._autograd_vg

    def _autograd_vg(self, thetas):
        """Batched autograd of ``model.log_target`` (the unfused path)."""
        vals, grads = self.model.upto_grad_log_target(thetas, self.x, self.y)
        return vals.to(torch.float32), grads.to(torch.float32)

    def init(self, theta0s):
        theta0s = torch.as_tensor(theta0s, dtype=torch.float32, device=self.device)
        vals, grads = self.vg(theta0s)
        step = torch.tensor(self.step0, dtype=torch.float32, device=self.device)
        tuner_state = (self.tuner or HMCDATuner(l=1.0)).init(step, dtype=torch.float32,
                                                              device=self.device)
        if self.tuner is not None:
            num_steps = self.tuner.num_steps(step)
        else:
            num_steps = torch.tensor(self.num_steps0, dtype=torch.int32, device=self.device)
        return FusedHMCState(theta0s, vals, grads, step, num_steps, tuner_state)

    def leapfrog(self, thetas, momenta, grads, step, num_steps):
        """``num_steps`` (a host int) leapfrog steps: half step of the
        momenta, alternating full steps, a final half step; the returned
        momenta are negated."""
        momenta = momenta + 0.5 * step * grads
        vals = torch.zeros(thetas.shape[0], dtype=thetas.dtype, device=thetas.device)
        for i in range(num_steps):
            thetas = thetas + step * momenta
            vals, grads = self.vg(thetas)
            factor = 0.5 if i == num_steps - 1 else 1.0
            momenta = momenta + factor * step * grads
        return thetas, -momenta, vals, grads

    def step_fn(self, state, iteration, num_burnin_iters, generator=None, momenta=None,
                uniforms=None):
        """One HMC transition of every chain at global iteration ``iteration``.
        ``momenta [C, P]`` and ``uniforms [C]`` are drawn from ``generator``
        unless given."""
        C = state.thetas.shape[0]
        if momenta is None:
            momenta = torch.randn(state.thetas.shape, generator=generator, dtype=torch.float32,
                                  device=self.device)
        h_cur = -state.target_vals + 0.5 * torch.sum(momenta * momenta, dim=1)

        num_steps = min(int(state.num_steps), self.max_num_steps)
        prop, prop_mom, prop_vals, prop_grads = self.leapfrog(
            state.thetas, momenta, state.grads, state.step, num_steps)
        h_prop = -prop_vals + 0.5 * torch.sum(prop_mom * prop_mom, dim=1)

        rates = torch.clamp(torch.exp(h_cur - h_prop), max=1.0)
        if uniforms is None:
            uniforms = torch.rand(C, generator=generator, dtype=torch.float32,
                                  device=self.device)
        accept = uniforms < rates

        thetas = torch.where(accept[:, None], prop, state.thetas)
        vals = torch.where(accept, prop_vals, state.target_vals)
        grads = torch.where(accept[:, None], prop_grads, state.grads)

        new_tuner, new_step, new_num_steps = state.tuner, state.step, state.num_steps
        if self.tuner is not None and iteration < num_burnin_iters:
            # the population acceptance drives the tuner; from the last
            # burn-in iteration on, the averaged step is kept
            return_e = iteration != num_burnin_iters - 1
            new_tuner, new_step, new_num_steps = self.tuner.tune(
                state.tuner, torch.mean(rates), iteration, return_e)

        new_state = FusedHMCState(thetas, vals, grads, new_step, new_num_steps, new_tuner)
        info = {"sample": thetas, "target_val": vals,
                "accepted": accept.to(torch.int32), "rate": rates}
        return new_state, info

    def run(self, seed, theta0s, num_iters, num_burnin_iters=0,
            record_keys=("sample", "target_val", "accepted")):
        """Returns (final_state, recorded {key: [num_iters - num_burnin_iters, C, ...]})."""
        unknown = set(record_keys) - set(RECORDABLE)
        if unknown:
            raise ValueError(f"unknown record keys {sorted(unknown)}; "
                             f"recordable: {sorted(RECORDABLE)}")
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        state = self.init(theta0s)
        C, P = state.thetas.shape
        kept = num_iters - num_burnin_iters
        recorded = {}
        for key in record_keys:
            tail, dtype = RECORDABLE[key]
            shape = (kept, C) + tuple(P if d == "P" else d for d in tail)
            recorded[key] = torch.empty(shape, dtype=dtype, device=self.device)
        for i in range(num_iters):
            state, info = self.step_fn(state, i, num_burnin_iters, generator=generator)
            if i >= num_burnin_iters:
                for key in record_keys:
                    recorded[key][i - num_burnin_iters] = info[key]
        return state, recorded
