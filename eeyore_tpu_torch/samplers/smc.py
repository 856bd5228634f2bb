"""Tempered Sequential Monte Carlo with systematic resampling.

Counterpart of ``eeyore_tpu/samplers/smc.py``: a population of particles
moves through a tempering schedule with importance reweighting,
ESS-triggered systematic resampling and MCMC mutation moves (MALA or MH at
the current temperature).

Tempering path: pi_beta ~ prior * lik^beta (beta: 0 -> 1), so beta = 0 is
the prior the particles are born from. For ``DistributionModel`` targets
(no prior/likelihood split), ``init_sampler(generator, n)`` supplies the
base distribution and ``base_log_pdf`` its log-density, and the geometric
path base^(1-beta) * target^beta is followed.

Where the JAX package vmaps and scans, the generic path here runs batched
tensors in Python loops over the stages and the mutation steps; every draw
comes from a ``torch.Generator`` (the resampling uniform of a stage before
its mutation draws), or is given (``_mutate``'s ``noise`` and ``uniforms``,
``_stage_core``'s ``u``), which is how the tests replay JAX's draws.
``run(backend="auto")`` sends an eligible run whose model and data live on a
CUDA device to the SMC runner of ``ops/resident_smc.py`` (each stage's
mutation pass one launch of ``csrc/resident_smc.cu``;
``samplers/dispatch.py::resolve_smc`` documents eligibility). Both paths
return ``SMCState.log_lik`` as zeros, as both JAX paths do.
"""

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from eeyore_tpu_torch.datasets import as_schedule
from eeyore_tpu_torch.models.model import BayesianModel


class SMCState(NamedTuple):
    particles: torch.Tensor    # [N, P]
    log_weights: torch.Tensor  # [N] (unnormalized)
    log_lik: torch.Tensor      # [N], zeros on both paths, as in JAX
    beta: torch.Tensor
    ess: torch.Tensor
    unique_frac: torch.Tensor  # fraction surviving the last stage's resample


def systematic_resample_indices(generator, norm_weights, u=None):
    """Systematic resampling: one uniform ``u`` (drawn from ``generator``
    unless given), N stratified positions against the weight CDF. Returns
    int64 indices [N]."""
    n = norm_weights.shape[0]
    like = dict(dtype=norm_weights.dtype, device=norm_weights.device)
    if u is None:
        u = torch.rand((), generator=generator, **like)
    positions = (u + torch.arange(n, **like)) / n
    cdf = torch.cumsum(norm_weights, 0)
    cdf = cdf / cdf[-1]
    return torch.searchsorted(cdf, positions)


def log_ess(log_weights):
    """log ESS = 2 logsumexp(w) - logsumexp(2w)."""
    return 2.0 * torch.logsumexp(log_weights, 0) - torch.logsumexp(2.0 * log_weights, 0)


def next_beta(log_w, pots, beta_prev, target_ess):
    """The largest b in (beta_prev, 1] with ESS(log_w + (b - beta_prev)
    pots) >= ``target_ess`` * N: 1 when that holds, else 30 bisection steps
    on the monotone ESS curve, advancing at least 1e-6. On device tensors in
    the dtype of ``log_w``, with no host synchronisation."""
    n = log_w.shape[0]
    like = dict(dtype=log_w.dtype, device=log_w.device)
    target = torch.tensor(target_ess * n, **like)
    one = torch.ones((), **like)
    beta_prev = torch.as_tensor(beta_prev, **like)

    def ess_at(b):
        return torch.exp(log_ess(log_w + (b - beta_prev) * pots))

    full_ok = ess_at(one) >= target
    lo, hi = beta_prev, one
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    # never stall: the bisection can collapse onto beta_prev when even tiny
    # increments break the target; force a minimal advance
    lo = torch.maximum(lo, beta_prev + torch.tensor(1e-6, **like))
    return torch.where(full_ok, one, torch.minimum(lo, one))


def reweight_and_resample(log_w, log_z, pots, beta_prev, beta, ess_threshold, generator,
                          force_resample=None, u=None):
    """Steps 1-2 of a stage, shared by both runners: reweight by lik^(beta -
    beta_prev) (``pots`` the log-likelihood potentials), add the log mean
    incremental weight under the previous normalization to ``log_z``, then
    decide to resample (ESS below ``ess_threshold`` * N, or
    ``force_resample``) and draw the systematic indices. Returns (log_w,
    log_z, ess, do_resample, idx, unique_frac), log_w zero where resampled;
    the caller gathers its particles by ``idx`` where ``do_resample``."""
    n = log_w.shape[0]
    incr = (beta - beta_prev) * pots
    log_z = log_z + torch.logsumexp(torch.log(torch.softmax(log_w, 0)) + incr, 0)
    log_w = log_w + incr
    ess = torch.exp(log_ess(log_w))
    do_resample = ess < ess_threshold * n
    if force_resample is not None:
        do_resample = do_resample | force_resample
    idx = systematic_resample_indices(generator, torch.softmax(log_w, 0), u=u)
    log_w = torch.where(do_resample, torch.zeros_like(log_w), log_w)
    survivors = torch.bincount(idx, minlength=n).clamp(0, 1).to(log_w.dtype).mean()
    unique_frac = torch.where(do_resample, survivors, torch.ones_like(survivors))
    return log_w, log_z, ess, do_resample, idx, unique_frac


def stack_diagnostics(outs):
    """Per-stage diagnostics {key: [stages]} on the CPU, in one copy each."""
    return {k: torch.stack([torch.as_tensor(o[k]) for o in outs]).cpu() for k in outs[0]}


def warn_truncated(num_stages, max_stages, final_beta):
    if num_stages >= max_stages and final_beta < 1.0:
        warnings.warn(
            f"adaptive SMC hit max_stages={max_stages} at beta={final_beta:.6f} < 1: the "
            "anneal is TRUNCATED and log_evidence covers only the completed ladder prefix; "
            "raise max_stages or adaptive_target_ess", RuntimeWarning)


class SMCSampler:
    def __init__(self, model, num_particles, betas=None, num_mutation_steps=2, mutation="MALA",
                 mutation_step=0.1, ess_threshold=0.5, init_sampler=None, base_log_pdf=None,
                 adaptive_target_ess=0.5, max_stages=50):
        """``betas``: increasing schedule ending at 1.0 (default: the
        reference's quartic ladder (i/10)^4, i = 0..10), or ``"adaptive"``
        to choose each next temperature by ESS bisection (``next_beta``),
        with at most ``max_stages`` stages. ``mutation``: "MALA" or "MH",
        ``mutation_step`` the proposal variance of both. ``ess_threshold``:
        resample when ESS < threshold * N. Non-Bayesian targets need
        ``init_sampler(generator, n) -> [n, P]`` and ``base_log_pdf(theta
        [..., P]) -> [...]``."""
        self.model = model
        self.num_particles = num_particles
        self.adaptive = isinstance(betas, str) and betas == "adaptive"
        if self.adaptive:
            self.betas = None
        else:
            if betas is None:
                betas = [(i / 10) ** 4 for i in range(0, 11)]
            self.betas = torch.as_tensor(np.asarray(betas, dtype=np.float64))
        self.adaptive_target_ess = float(adaptive_target_ess)
        self.max_stages = int(max_stages)
        self.num_mutation_steps = num_mutation_steps
        self.mutation = mutation
        self.mutation_step = mutation_step
        self.ess_threshold = ess_threshold

        self._is_bayesian = isinstance(model, BayesianModel)
        if not self._is_bayesian and (init_sampler is None or base_log_pdf is None):
            raise ValueError("non-Bayesian targets need init_sampler(generator, n) and "
                             "base_log_pdf")
        self.init_sampler = init_sampler
        self.base_log_pdf = base_log_pdf

    # ---- tempered target pieces, over particles [N, P] ----

    def _potential(self, theta, x, y):
        """The tempered increment U in log pi_beta = base + beta * U: the
        log-likelihood for Bayesian models; for raw log-density targets, log
        target - log base (the geometric path)."""
        if self._is_bayesian:
            return self.model.log_lik(theta, x, y)
        return self.model.log_target(theta, x, y) - self.base_log_pdf(theta)

    def _base(self, theta):
        """The beta-independent part: the log-prior or the base log-pdf."""
        if self._is_bayesian:
            return self.model.log_prior(theta)
        return self.base_log_pdf(theta)

    def _tempered_target(self, theta, beta, x, y):
        return self._base(theta) + beta * self._potential(theta, x, y)

    # ---- particle birth ----

    def _sample_init(self, generator=None):
        if self._is_bayesian:
            return self.model.prior.sample(generator, (self.num_particles,))
        return torch.as_tensor(self.init_sampler(generator, self.num_particles))

    # ---- mutation: num_mutation_steps of MALA or MH at fixed beta ----

    def _mutate(self, generator, particles, beta, x, y, noise=None, uniforms=None):
        """``num_mutation_steps`` moves of every particle at temperature
        ``beta``; ``noise`` [steps, N, P] (standard normals) and
        ``uniforms`` [steps, N] are drawn from ``generator`` unless given.
        Returns (particles, each particle's acceptance rate [N])."""
        step = self.mutation_step
        sqrt_step = math.sqrt(step)
        mala = self.mutation == "MALA"
        like = dict(dtype=particles.dtype, device=particles.device)

        def target(theta):
            return self._tempered_target(theta, beta, x, y)

        def value_and_grad(theta):
            with torch.enable_grad():
                theta = theta.detach().requires_grad_(True)
                val = target(theta)
                (grad,) = torch.autograd.grad(val.sum(), theta)
            return val.detach(), grad

        def log_q(v, loc):
            z = (v - loc) / sqrt_step
            return torch.sum(-0.5 * z * z, dim=-1)

        theta = particles
        if mala:
            tv, gv = value_and_grad(theta)
        else:
            tv = target(theta)
        accepted = torch.zeros(theta.shape[0], **like)
        for s in range(self.num_mutation_steps):
            z = (noise[s] if noise is not None
                 else torch.randn(theta.shape, generator=generator, **like))
            if mala:
                mean = theta + 0.5 * step * gv
                prop = mean + sqrt_step * z
                ptv, pgv = value_and_grad(prop)
                rev_mean = prop + 0.5 * step * pgv
                log_rate = ptv - tv - log_q(prop, mean) + log_q(theta, rev_mean)
            else:
                prop = theta + sqrt_step * z
                ptv = target(prop)
                log_rate = ptv - tv
            u = (uniforms[s] if uniforms is not None
                 else torch.rand(theta.shape[0], generator=generator, **like))
            acc = torch.log(u) < log_rate
            theta = torch.where(acc[:, None], prop, theta)
            tv = torch.where(acc, ptv, tv)
            if mala:
                gv = torch.where(acc[:, None], pgv, gv)
            accepted = accepted + acc.to(accepted.dtype)
        return theta, accepted / self.num_mutation_steps

    # ---- adaptive next temperature: ESS bisection ----

    def _next_beta(self, log_w, pots, beta_prev):
        """``next_beta`` at ``adaptive_target_ess``."""
        return next_beta(log_w, pots, beta_prev, self.adaptive_target_ess)

    # ---- the annealing pass ----

    def _stage_core(self, generator, particles, log_w, log_z, pots, beta_prev, beta, x, y,
                    force_resample=None, u=None, noise=None, uniforms=None):
        """Reweight -> ESS-triggered systematic resample -> mutate: the body
        of the fixed schedule and of the adaptive loop. ``force_resample``:
        the adaptive runner's extra trigger when the bisection's constraint
        binds (beta < 1), where the landed ESS sits just above the threshold
        and the pure test would never fire, stalling the ladder at forced
        minimal advances. ``u``, ``noise``, ``uniforms``: given draws (the
        resampling uniform, ``_mutate``'s)."""
        log_w, log_z, ess, do_resample, idx, unique_frac = reweight_and_resample(
            log_w, log_z, pots, beta_prev, beta, self.ess_threshold, generator,
            force_resample=force_resample, u=u)
        particles = torch.where(do_resample, particles[idx], particles)
        particles, acc = self._mutate(generator, particles, beta, x, y, noise=noise,
                                      uniforms=uniforms)
        out = {"beta": beta, "ess": ess, "resampled": do_resample,
               "mutation_acceptance": torch.mean(acc), "unique_frac": unique_frac}
        return particles, log_w, log_z, out

    def run(self, generator, data, record=False, backend="auto", platform=None):
        """Anneal prior -> posterior over the schedule (fixed, or adaptive
        when constructed with ``betas="adaptive"``). ``data`` (x, y) is moved
        to the model's device and dtype.

        Returns (final ``SMCState``, diagnostics {per-stage "beta", "ess",
        "resampled", "mutation_acceptance", "unique_frac" as CPU tensors;
        "log_evidence", the log normalizing-constant estimate; adaptive runs
        add "num_stages" and stop the per-stage arrays at the stages run}).

        ``backend="auto"`` (default) sends an eligible run whose model and
        data live on a CUDA device to the SMC runner on the mutation kernel
        (``samplers/dispatch.py::resolve_smc``): architecture models to
        ``csrc/resident_smc.cu``, ``DistributionModel`` targets with a base
        to ``csrc/resident_smc_closure.cu``. Its draws come from a seed taken
        from ``generator``, so its runs are statistically equivalent to the
        generic path's, not equal; "scan" forces the generic path.
        ``platform`` overrides the device type that dispatch sees; a CUDA
        plan on CPU tensors runs the plain mutation pass. ``record`` is
        accepted and ignored, as in the JAX package, whose ``run`` never
        reads it."""
        model = self.model
        schedule = as_schedule(data).to(device=getattr(model, "device", None),
                                        dtype=getattr(model, "dtype", None))
        if schedule.num_batches != 1:
            raise ValueError("SMC runs full-batch: pass (x, y)")
        if backend != "scan":
            from eeyore_tpu_torch.samplers.dispatch import resolve_smc, run_smc_backend

            plan, _reason = resolve_smc(self, schedule, backend=backend, platform=platform)
            if plan is not None:
                return run_smc_backend(self, generator, schedule, plan)
        x, y = schedule.batch(0)
        if self.adaptive:
            return self._run_adaptive(generator, x, y)

        particles = self._sample_init(generator)
        n = self.num_particles
        like = dict(dtype=particles.dtype, device=particles.device)
        log_w = torch.zeros(n, **like)
        log_z = torch.zeros((), **like)
        betas = self.betas.to(**like)
        outs = []
        for k in range(1, len(betas)):
            pots = self._potential(particles, x, y)
            particles, log_w, log_z, out = self._stage_core(
                generator, particles, log_w, log_z, pots, betas[k - 1], betas[k], x, y)
            outs.append(out)
        state = SMCState(particles=particles, log_weights=log_w,
                         log_lik=torch.zeros(n, **like), beta=betas[-1],
                         ess=torch.exp(log_ess(log_w)), unique_frac=outs[-1]["unique_frac"])
        diagnostics = stack_diagnostics(outs)
        diagnostics["log_evidence"] = float(log_z)
        return state, diagnostics

    def _run_adaptive(self, generator, x, y):
        """Adaptive tempering: stages until beta reaches 1 or ``max_stages``,
        each temperature from ``_next_beta``; one host read of beta a stage."""
        particles = self._sample_init(generator)
        n = self.num_particles
        like = dict(dtype=particles.dtype, device=particles.device)
        log_w = torch.zeros(n, **like)
        log_z = torch.zeros((), **like)
        beta = torch.zeros((), **like)
        outs = []
        while float(beta) < 1.0 and len(outs) < self.max_stages:
            pots = self._potential(particles, x, y)
            new_beta = self._next_beta(log_w, pots, beta)
            particles, log_w, log_z, out = self._stage_core(
                generator, particles, log_w, log_z, pots, beta, new_beta, x, y,
                force_resample=new_beta < 1.0)
            beta = new_beta
            outs.append(out)
        num_stages = len(outs)
        warn_truncated(num_stages, self.max_stages, float(beta))
        state = SMCState(particles=particles, log_weights=log_w,
                         log_lik=torch.zeros(n, **like), beta=beta,
                         ess=torch.exp(log_ess(log_w)), unique_frac=outs[-1]["unique_frac"])
        diagnostics = stack_diagnostics(outs)
        diagnostics["num_stages"] = num_stages
        diagnostics["log_evidence"] = float(log_z)
        return state, diagnostics

    @staticmethod
    def estimate(state, f=None):
        """Self-normalized importance estimate of E_pi[f] from the final
        particle cloud; ``f`` maps particles [N, P] to [N, ...] (the
        identity when None)."""
        w = torch.softmax(state.log_weights, 0)
        vals = state.particles if f is None else f(state.particles)
        return torch.tensordot(w.to(vals.dtype), vals, dims=1)
