"""Power-posterior / parallel-tempering population MCMC.

Counterpart of ``eeyore_tpu/samplers/power_posterior.py``: a ladder of
``num_chains`` tempered targets with default temperatures (i/N)^4 for i =
1..N, the coldest (temperature 1) chain last; per iteration a within-chain
MH or MALA move on every rung, and every ``between_step`` iterations a
round of swap moves, either the reference's serial categorical sweep
(partner j of chain i drawn with P(j | i) ~ exp(-b |j - i|)) or even/odd
adjacent-pair swaps.

Where the JAX package vmaps one kernel per temperature, the within moves
here are one batched MALA or MH step of the whole ladder on
``model.with_temperature(temps)``, ``temps`` the [L] tensor of rung
temperatures, which the model's tempering broadcasts over the chains. The
recorded ``target_val`` and ``grad_val`` are tempered, as in JAX. Every
random draw comes from a ``torch.Generator``, or is given
(``_within_moves``'s ``draws``, the swap moves' ``uniforms`` and
``partners``), which is how the tests replay JAX's draws.

The state may also hold G independent ladders, ladder-major (chain g L +
rung), as the kernels lay them out: ``init`` takes thetas [G L, P], and the
within moves and the even/odd swaps never pair chains of two ladders, so
``sample_population`` runs G ladders at the cost of one. The categorical
sweep runs one ladder.

``run(backend="auto")`` sends an eligible even/odd ladder whose model and
data live on a CUDA device to one launch of a whole-loop tempering kernel
(``samplers/dispatch.py::resolve_tempering``); categorical ladders and
everything on the CPU run the generic ladder here.
"""

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from eeyore_tpu_torch.samplers.mala import MALA
from eeyore_tpu_torch.samplers.mh import MetropolisHastings
from eeyore_tpu_torch.samplers.population import PopulationKernel, sample_population
from eeyore_tpu_torch.samplers.runner import _prepare


def default_temperatures(num_chains):
    """(i/N)^4 for i = 1..N (reference power_posterior_sampler.py:91-92)."""
    return np.array([(i / num_chains) ** 4 for i in range(1, num_chains + 1)])


def categorical_swap_probs(num_chains, b=0.5):
    """P[i, j] = P(partner j | chain i) ~ exp(-b |j - i|), j != i, rows
    normalized by the truncated-geometric sum (reference :107-122)."""
    eb = math.exp(-b)
    P = np.zeros((num_chains, num_chains))
    for i in range(num_chains):
        denom = eb * (2 - eb**i - eb ** (num_chains - 1 - i)) / (1 - eb)
        for j in range(num_chains):
            if j != i:
                P[i, j] = eb ** abs(j - i) / denom
    return P


class PPState(NamedTuple):
    inner: Any  # the ladder's MALAState or MHState, leaves [num_chains, ...]


class PowerPosteriorSampler(PopulationKernel):
    state_keys = ("sample", "target_val", "accepted")

    def __init__(self, model, num_chains, sampler="MALA", sampler_kwargs=None,
                 temperature=None, between_step=10, b=0.5, swap_scheme="categorical",
                 recompute_current=False):
        super().__init__(model, recompute_current=recompute_current)
        if getattr(model, "temperature", None) is not None:
            raise ValueError("pass an untempered model; the ladder applies temperatures")
        self.num_chains = num_chains
        self.sampler = sampler
        self.sampler_kwargs = sampler_kwargs or {}
        self.between_step = between_step
        self.b = b
        self.swap_scheme = swap_scheme

        if temperature is None:
            temperature = default_temperatures(num_chains)
        elif len(temperature) != num_chains:
            raise ValueError("len(temperature) != num_chains")
        self.temperatures = torch.as_tensor(np.asarray(temperature, dtype=np.float64))
        self._swap_probs = torch.as_tensor(categorical_swap_probs(num_chains, b))
        self._has_grad = sampler == "MALA"

    def default_indicator(self):
        """Accessors address the coldest (last) chain by default (reference
        :84-85)."""
        return self.num_chains - 1

    def _temps(self, like):
        """The temperature of each chain of ``like`` [G L, ...]: rung c % L."""
        return self.temperatures.to(dtype=like.dtype,
                                    device=like.device).repeat(like.shape[0] // self.num_chains)

    def _make_kernel(self, temps):
        model_t = self.model.with_temperature(temps)
        if self.sampler == "MALA":
            return MALA(model_t, recompute_current=self.recompute_current, **self.sampler_kwargs)
        if self.sampler == "MetropolisHastings":
            return MetropolisHastings(model_t, recompute_current=self.recompute_current,
                                      **self.sampler_kwargs)
        raise ValueError(f"unsupported ladder sampler {self.sampler!r} "
                         "(reference supports MetropolisHastings and MALA)")

    def _base_val_grad(self, thetas, x, y):
        """Untempered log-targets [n] (and gradients [n, P] for MALA, else
        None) of ``thetas [n, P]``."""
        if self._has_grad:
            return self.model.upto_grad_log_target(thetas, x, y)
        return self.model.log_target(thetas, x, y), None

    # ------------------------------------------------------------------

    def init(self, thetas, x, y, generator=None):
        """The ladder's state at ``thetas`` [L, P], or at one theta [P] for
        every rung (as the reference starts it); [G L, P] starts G ladders."""
        thetas = torch.as_tensor(thetas)
        if thetas.dim() == 1:
            thetas = thetas.expand(self.num_chains, -1).contiguous()
        if thetas.shape[0] % self.num_chains:
            raise ValueError(f"{thetas.shape[0]} chains do not make whole ladders of "
                             f"{self.num_chains}")
        return PPState(inner=self._make_kernel(self._temps(thetas)).init(thetas, x, y))

    def _within_moves(self, inner, x, y, generator=None, draws=None):
        """One MALA or MH step of every rung at its temperature. ``draws``:
        (normals [L, P] (MALA) or proposals [L, P] (MH), uniforms [L]) in
        place of draws from ``generator``."""
        kern = self._make_kernel(self._temps(inner.sample))
        if draws is None:
            return kern.step(inner, x, y, generator=generator)[0]
        first, uniforms = draws
        if self._has_grad:
            return kern.step_fn(inner, x, y, noise=first, uniforms=uniforms)[0]
        return kern.step_fn(inner, x, y, proposal=first, uniforms=uniforms)[0]

    # ---- swap moves ----

    def _apply_swap(self, inner, i, j, accept, vals, grads):
        """Swap the states of chains i and j where ``accept``, with their
        tempered targets (and gradients) at the new positions; ``vals`` and
        ``grads`` are the untempered ones of (theta_i, theta_j)."""
        temps = self._temps(inner.sample)

        def upd(leaf, vi, vj):
            leaf = leaf.clone()
            leaf[i] = torch.where(accept, vi, leaf[i])
            leaf[j] = torch.where(accept, vj, leaf[j])
            return leaf

        replacements = {
            "sample": upd(inner.sample, inner.sample[j], inner.sample[i]),
            "target_val": upd(inner.target_val, temps[i] * vals[1], temps[j] * vals[0])}
        if self._has_grad:
            replacements["grad_val"] = upd(inner.grad_val, temps[i] * grads[1],
                                           temps[j] * grads[0])
        return inner._replace(**replacements)

    def _between_moves_categorical(self, inner, x, y, generator=None, partners=None,
                                   uniforms=None):
        """Serial sweep i = 0..N-1, chain i swapping with a partner drawn
        from the categorical ``P[i]`` (the reference's between_chain_moves,
        :165-169). ``partners`` [N] and ``uniforms`` [N]: the draws of each
        step, in place of draws from ``generator``."""
        if inner.sample.shape[0] != self.num_chains:
            raise ValueError("the categorical sweep runs one ladder")
        P = self._swap_probs.to(dtype=inner.sample.dtype, device=inner.sample.device)
        logP = torch.log(torch.where(P > 0, P, torch.ones_like(P)))
        temps = self._temps(inner.sample)
        for i in range(self.num_chains):
            if partners is None:
                j = int(torch.multinomial(P[i], 1, generator=generator))
                u = torch.rand((), generator=generator, dtype=inner.sample.dtype,
                               device=inner.sample.device)
            else:
                j, u = int(partners[i]), uniforms[i]
            vals, grads = self._base_val_grad(inner.sample[[i, j]], x, y)
            # log-rate (reference :135-141): P(i|j) - P(j|i) - pi_i(th_i)
            # - pi_j(th_j) + pi_i(th_j) + pi_j(th_i)
            log_rate = (logP[j, i] - logP[i, j]
                        - inner.target_val[i] - inner.target_val[j]
                        + temps[i] * vals[1] + temps[j] * vals[0])
            inner = self._apply_swap(inner, i, j, torch.log(u) < log_rate, vals, grads)
        return inner

    def _between_moves_even_odd(self, inner, x, y, iteration, generator=None, uniforms=None):
        """Vectorized adjacent-pair swaps; parity alternates per swap round.
        Both members of a pair test one uniform: ``uniforms`` [N] gives each
        chain its pair's, in place of one draw per pair from ``generator``."""
        N, L = inner.sample.shape[0], self.num_chains
        temps = self._temps(inner.sample)
        parity = (iteration // self.between_step) % 2
        idx = torch.arange(N, device=inner.sample.device)
        rung = idx % L
        is_lower = (rung % 2) == parity
        partner = torch.where(is_lower, idx + 1, idx - 1)
        valid = torch.where(is_lower, rung < L - 1, rung > 0)  # within the ladder
        partner = torch.clamp(partner, 0, N - 1)

        base, grads = self._base_val_grad(inner.sample, x, y)
        # pairwise log-rate evaluated identically on both members of a pair
        log_rate = (-inner.target_val - inner.target_val[partner]
                    + temps * base[partner] + temps[partner] * base)
        if uniforms is None:
            pair_u = torch.rand(N, generator=generator, dtype=inner.sample.dtype,
                                device=inner.sample.device)
            uniforms = pair_u[torch.minimum(idx, partner)]
        accept = valid & (torch.log(uniforms) < log_rate)

        replacements = {
            "sample": torch.where(accept[:, None], inner.sample[partner], inner.sample),
            "target_val": torch.where(accept, temps * base[partner], inner.target_val)}
        if self._has_grad:
            replacements["grad_val"] = torch.where(accept[:, None],
                                                   temps[:, None] * grads[partner],
                                                   inner.grad_val)
        return inner._replace(**replacements)

    # ------------------------------------------------------------------

    def step(self, state, x, y, iteration, generator=None):
        inner = self._within_moves(state.inner, x, y, generator=generator)
        if iteration % self.between_step == 0:
            if self.swap_scheme == "categorical":
                inner = self._between_moves_categorical(inner, x, y, generator=generator)
            else:
                inner = self._between_moves_even_odd(inner, x, y, iteration,
                                                     generator=generator)
        return PPState(inner=inner), {k: getattr(inner, k) for k in self.state_keys}

    def run(self, generator, theta0, data, num_iters, num_burnin_iters=0, record_keys=None,
            backend="auto", all_ladders=False, platform=None):
        """Run the ladder from ``theta0`` ([P] for every rung, or [L, P]);
        returns a ``ChainLists`` with one chain per rung, the coldest last,
        as the reference orders them.

        ``backend="auto"`` (default) sends an eligible even/odd ladder whose
        model and data live on a CUDA device to a whole-loop tempering kernel
        (``samplers/dispatch.py::resolve_tempering`` documents eligibility and
        the recorded keys); categorical ladders and everything on the CPU run
        the generic ladder, which ``"scan"`` forces. ``platform`` overrides
        the device type that dispatch sees; a CUDA plan on CPU tensors runs
        the kernel's plain version.

        ``all_ladders=True``: on a kernel backend, return every independent
        ladder the kernel's block computed (chain_block / L of them,
        ladder-major) instead of ladder 0 alone. The generic path runs one
        ladder, so there it changes nothing."""
        theta0, schedule = _prepare(self, theta0, data, num_iters, num_burnin_iters, 1)
        if backend != "scan":
            from eeyore_tpu_torch.samplers.dispatch import (
                resolve_tempering,
                run_tempering_backend,
            )

            plan, _reason = resolve_tempering(self, schedule, num_iters, num_burnin_iters,
                                              backend=backend, platform=platform,
                                              record_keys=record_keys)
            if plan is not None:
                return run_tempering_backend(self, generator, theta0, schedule, num_iters,
                                             num_burnin_iters, plan, all_ladders=all_ladders)
        return sample_population(self, generator, theta0, schedule, num_iters, num_burnin_iters,
                                 record_keys=record_keys)
