"""No-U-Turn Sampler (NUTS) over a population of chains.

Counterpart of ``eeyore_tpu/samplers/nuts.py``: multinomial NUTS (Hoffman and
Gelman 2014, with Betancourt's multinomial weights) in its iterative,
fixed-memory form. The trajectory doubles up to ``max_depth`` times in a
random direction; within a subtree, U-turns are checked against every
complete binary subtree through a checkpoint stack (leaf ``n`` stored at slot
``popcount(n)`` when even, checked against the slots ``[popcount(n) -
trailing_ones(n), popcount(n) - 1]`` when odd); proposals are drawn
progressively with multinomial weights, and a finished subtree merges with
Betancourt's biased progressive sampling. A doubling whose subtree U-turns or
diverges (a log-joint drop over 1000) is discarded and ends the trajectory.
Subtrees integrate with a positive step from the chosen end with the
momentum oriented by the direction, and the new end is installed with the
forward-time momentum.

Where the JAX package vmaps one chain, every tensor here carries the chains
as its first dimension. The adaptive tree runs while any chain is live,
depth by depth and leaf by leaf, and a chain that has stopped keeps its state
(JAX's per-chain while loops end there). ``fixed_budget=True`` runs every
leaf of every depth with masked algebra, as the kernels do, and draws the
same samples as the adaptive tree at equal ``max_depth``.

``step_fn`` takes its draws as arguments (momentum normals, directions, leaf
and merge uniforms) or draws them from a ``torch.Generator``; the tuner is
JAX's per-chain dual averaging, and ``mass_adapt`` its diagonal-metric
warmup. ``choose_max_depth`` and ``resolve_auto_budget`` are the depth probe
behind ``max_depth="auto"``. JAX's ``_jit_cache`` has no counterpart: PyTorch
runs eagerly.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from eeyore_tpu_torch.samplers.hmc import HMC, _per_chain
from eeyore_tpu_torch.tuners.dual_averaging import DualAveragingState, HMCDATuner

DIVERGENCE_THRESHOLD = 1000.0
CRITERIA = ("quantile", "ess")


def _popcount(n):
    """Set bits of each entry of ``n`` (an int or an integer tensor of
    values below 2**32), as int32."""
    n = torch.as_tensor(n, dtype=torch.int64)
    count = torch.zeros_like(n)
    for i in range(32):
        count = count + ((n >> i) & 1)
    return count.to(torch.int32)


def _trailing_ones(n):
    # n ^ (n+1) is a mask of the trailing-ones run plus the bit above it.
    n = torch.as_tensor(n, dtype=torch.int64)
    return _popcount(n ^ (n + 1)) - 1


def _is_uturn(dtheta, v_left, v_right):
    """The generalized U-turn criterion on velocities v = M^-1 r, per chain
    ([C, P] -> [C] bool)."""
    return ((dtheta * v_left).sum(-1) < 0) | ((dtheta * v_right).sum(-1) < 0)


def _where(cond, new, old):
    """``torch.where`` with a per-chain [C] condition over [C] or [C, P]
    values."""
    if new.dim() == 2:
        cond = cond[:, None]
    return torch.where(cond, new, old)


class NUTSState(NamedTuple):
    sample: torch.Tensor         # [C, P]
    target_val: torch.Tensor     # [C]
    grad_val: torch.Tensor       # [C, P]
    accepted: torch.Tensor       # [C] int32: 1 if the sample moved off the previous one
    accept_stat: torch.Tensor    # [C] mean Metropolis statistic over the trajectory
    depth: torch.Tensor          # [C] int32 kept doublings (Stan's treedepth)
    num_leapfrogs: torch.Tensor  # [C] int32 gradient evaluations of the transition
    divergent: torch.Tensor      # [C] int32 1 if the trajectory ended in a divergence
    step: torch.Tensor           # [C] leapfrog step (tuner-dynamic)
    inv_mass: torch.Tensor       # [C, P] diagonal of M^-1 (ones unless mass_adapt froze it)
    wf_mean: torch.Tensor        # [C, P] Welford mean of the burn-in samples
    wf_m2: torch.Tensor          # [C, P] Welford sum of squared deviations
    wf_n: torch.Tensor           # [C] int32 Welford count
    tuner: DualAveragingState    # fields [C]


class _Tree(NamedTuple):
    """The carry of the doubling loop, per chain."""
    theta_l: torch.Tensor
    r_l: torch.Tensor
    grad_l: torch.Tensor
    theta_r: torch.Tensor
    r_r: torch.Tensor
    grad_r: torch.Tensor
    prop_theta: torch.Tensor
    prop_target: torch.Tensor
    prop_grad: torch.Tensor
    lse: torch.Tensor
    sum_alpha: torch.Tensor
    num_alpha: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    kept_depth: torch.Tensor


class _Subtree(NamedTuple):
    """The carry of a subtree's leaf loop, per chain."""
    theta: torch.Tensor
    rho: torch.Tensor
    target: torch.Tensor
    grad: torch.Tensor
    lse: torch.Tensor
    prop_theta: torch.Tensor
    prop_target: torch.Tensor
    prop_grad: torch.Tensor
    sum_alpha: torch.Tensor
    num_alpha: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor


def _select(cond, new, old):
    """Field-wise ``_where`` of two NamedTuples of per-chain tensors."""
    return type(old)(*(_where(cond, a, b) for a, b in zip(new, old)))


def _probe_run(kernel, schedule, theta0s, num_iters, num_burnin_iters, record_key, generator):
    """One probe run of ``choose_max_depth`` on the generic path: (final
    state, recorded [C, kept, ...] tensor of ``record_key``)."""
    from eeyore_tpu_torch.samplers.runner import sample_chains

    recorded, state = sample_chains(kernel, generator, theta0s, schedule, num_iters,
                                    num_burnin_iters, record_keys=(record_key,),
                                    return_state=True, return_arrays=True, backend="scan")
    return state, recorded[record_key]


def _ess_score(samples, depth):
    """Mean multivariate ESS (INSE) of the chains of ``samples`` [C, kept, P]
    per leapfrog of a depth-``depth`` tree, None when no chain has enough
    samples."""
    from eeyore_tpu_torch.stats import multi_ess

    ess = []
    for c in range(samples.shape[0]):
        try:
            ess.append(multi_ess(samples[c], method="inse"))
        except RuntimeError:
            pass
    if not ess:
        return None
    return float(np.mean(ess)) / (2 ** depth - 1)


def choose_max_depth(model, data, step=0.1, num_warmup=256, num_chains=16, quantile=0.95,
                     probe_max_depth=10, tuner=None, generator=None, theta0s=None, dtype=None,
                     mass_adapt=False, return_metric=False, criterion="quantile",
                     candidate_depths=None):
    """Depth probe for fixed-budget NUTS (JAX's ``choose_max_depth``): runs
    ``num_warmup`` adaptive NUTS transitions over ``num_chains`` chains (the
    tuner active for the first half), then freezes ``max_depth = ceil(the
    quantile of the kept tree depths)`` over the second half, in [1,
    ``probe_max_depth``]. Returns ``(max_depth, tuned_step)``, plus the
    chain-averaged frozen ``inv_mass`` [P] (float64 numpy) with
    ``return_metric`` (meaningful with ``mass_adapt``).

    ``criterion="ess"`` then scores each candidate depth (default: 2 up to
    the quantile depth) by the mean INSE ESS per leapfrog of a fixed-budget
    run at the tuned step, and keeps the best. The runs draw from
    ``generator``; without ``theta0s`` the inits are prior draws."""
    from eeyore_tpu_torch.datasets import as_schedule

    if criterion not in CRITERIA:
        raise ValueError(f"criterion must be 'quantile' or 'ess', got {criterion!r}")
    schedule = as_schedule(data)
    burnin = num_warmup // 2
    if tuner is None:
        tuner = HMCDATuner(d=0.8)
    kernel = NUTS(model, step=step, max_depth=probe_max_depth, tuner=tuner,
                  num_burnin_iters=burnin, mass_adapt=mass_adapt)
    if theta0s is None:
        theta0s = model.prior.sample(generator, (num_chains,))
    else:
        theta0s = torch.as_tensor(theta0s)
        num_chains = theta0s.shape[0]
    if dtype is not None:
        theta0s = theta0s.to(dtype)
    state, depths = _probe_run(kernel, schedule, theta0s, num_warmup, burnin, "depth",
                               generator)
    d = int(math.ceil(float(np.quantile(depths.cpu().numpy(), quantile))))
    d = max(1, min(d, probe_max_depth))
    tuned_step = float(state.step.double().mean())

    if criterion == "ess":
        candidates = tuple(candidate_depths or range(max(1, min(2, d)), d + 1))
        best_d, best_score = d, -1.0
        for cand in candidates:
            probe = NUTS(model, step=tuned_step, max_depth=cand, fixed_budget=True,
                         num_burnin_iters=burnin)
            _, samples = _probe_run(probe, schedule, theta0s, num_warmup, burnin, "sample",
                                    generator)
            score = _ess_score(samples.double().cpu(), cand)
            if score is not None and score > best_score:
                best_d, best_score = cand, score
        d = best_d

    if return_metric:
        return d, tuned_step, state.inv_mass.double().mean(dim=0).cpu().numpy()
    return d, tuned_step


class NUTS(HMC):
    """No-U-Turn kernel. ``step`` is the leapfrog step; the trajectory length
    is chosen per transition, up to ``2**max_depth - 1`` leapfrog steps.
    Dual averaging reuses ``HMCDATuner`` on the trajectory-mean Metropolis
    statistic (a tuner without ``l``; one with ``l`` runs on the generic
    path, which ignores it, and the kernel makers refuse it, as in JAX).
    ``max_depth="auto"`` probes the depth and step on the first data the
    kernel runs on (``resolve_auto_budget``, called by the runners)."""

    state_keys = ("sample", "target_val", "grad_val", "accepted", "accept_stat",
                  "depth", "num_leapfrogs", "divergent")

    def __init__(self, model, step=0.1, max_depth=10, tuner=None, num_burnin_iters=0,
                 recompute_current=False, mass_adapt=False, fixed_budget=False):
        super().__init__(model, step=step, num_steps=1, tuner=tuner,
                         num_burnin_iters=num_burnin_iters,
                         recompute_current=recompute_current)
        self.auto_depth = isinstance(max_depth, str) and max_depth == "auto"
        self._auto_fingerprint = None
        self._frozen_inv_mass = None  # set by resolve_auto_budget with mass_adapt
        self.max_depth = 10 if self.auto_depth else int(max_depth)
        # Stan's diagonal metric warmup: Welford over [B/4, B/2) of burn-in,
        # frozen at B/2 with a warm restart of the tuner (B >= 20)
        self.mass_adapt = bool(mass_adapt)
        self.fixed_budget = bool(fixed_budget)

    def resolve_auto_budget(self, data, generator=None, num_warmup=256, num_chains=16,
                            quantile=0.95, theta0s=None, probe_max_depth=4, criterion="ess"):
        """Resolve ``max_depth="auto"``: run the ``choose_max_depth`` probe
        once per dataset and freeze the probed depth and step (and, with
        ``mass_adapt``, the chain-averaged metric) onto this kernel, which
        then dispatches as fixed-budget NUTS. Idempotent per data
        fingerprint; a no-op for an explicit depth. The probe's seed is
        drawn from ``generator``; a prior-less model needs ``theta0s``
        (the runners pass the run's own)."""
        if not self.auto_depth:
            return
        from eeyore_tpu_torch.datasets import as_schedule
        from eeyore_tpu_torch.samplers.runner import _generator_or_default

        schedule = as_schedule(data)
        xb = schedule.x[0].cpu().numpy()
        yb = schedule.y[0].cpu().numpy()
        fp = (xb.shape, hash(xb.tobytes()), yb.shape, hash(yb.tobytes()))
        if fp == self._auto_fingerprint:
            return
        if theta0s is None and not hasattr(self.model, "prior"):
            raise ValueError(
                "max_depth='auto' on a prior-less model needs probe inits: pass theta0s to "
                "resolve_auto_budget (the samplers' runners forward the run's own theta0s)")
        if theta0s is not None:
            theta0s = torch.as_tensor(theta0s)[:num_chains]
        # the probe runs where its inits live: the run's, or the prior's draws
        device = (theta0s.device if theta0s is not None
                  else torch.device(getattr(self.model, "device", schedule.x.device)))
        caller = _generator_or_default(generator, device)
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), device=caller.device, generator=caller))
        probe_gen = torch.Generator(device=device).manual_seed(seed)
        out = choose_max_depth(
            self.model, schedule, step=self.step0, num_warmup=num_warmup, num_chains=num_chains,
            quantile=quantile, theta0s=theta0s, probe_max_depth=probe_max_depth,
            criterion=criterion, generator=probe_gen, mass_adapt=self.mass_adapt,
            return_metric=self.mass_adapt)
        if self.mass_adapt:
            d, e, self._frozen_inv_mass = out
        else:
            d, e = out
        self.max_depth = d
        self.step0 = e
        if self.tuner is not None and self.tuner.e0 is None:
            # warm-start the dual averager at the probed step
            self.tuner.e0 = e
        self._auto_fingerprint = fp
        self._backend_cache = {}

    def init(self, thetas, x, y, generator=None):
        """State of every chain at ``thetas [C, P]``. A tuner without ``e0``
        starts each chain at its ``find_initial_step`` with momenta from
        ``generator`` when one is given, else at ``step``."""
        thetas = torch.as_tensor(thetas)
        target, grad = self.upto_grad_log_target(thetas, x, y)
        like = thetas[:, 0]
        dtype, device = thetas.dtype, thetas.device

        step = _per_chain(self.step0, like)
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
            tuner_state = self.tuner.init(step, dtype=dtype, device=device)
        else:
            tuner_state = HMCDATuner(l=1.0).init(step, dtype=dtype, device=device)  # inert

        zero_i = torch.zeros_like(like, dtype=torch.int32)
        return NUTSState(
            sample=thetas, target_val=target, grad_val=grad, accepted=zero_i,
            accept_stat=torch.zeros_like(like), depth=zero_i, num_leapfrogs=zero_i,
            divergent=zero_i, step=step.clone(), inv_mass=torch.ones_like(thetas),
            wf_mean=torch.zeros_like(thetas), wf_m2=torch.zeros_like(thetas), wf_n=zero_i,
            tuner=tuner_state)

    # ---- one leapfrog step of every chain ----

    def _leapfrog_one(self, theta, rho, grad, step, inv_mass, x, y):
        """``step`` [C, 1]; the position moves at the velocity M^-1 rho."""
        rho = rho + 0.5 * step * grad
        theta = theta + step * (inv_mass * rho)
        target, grad = self.upto_grad_log_target(theta, x, y)
        rho = rho + 0.5 * step * grad
        return theta, rho, target, grad

    def _leaf(self, c, step, inv_mass, logp0, x, y):
        """The next leaf of every chain's subtree: (theta, rho, target,
        grad, log weight relative to the trajectory start, divergent, the
        Metropolis statistic with NaN set to 0)."""
        theta, rho, target, grad = self._leapfrog_one(c.theta, c.rho, c.grad, step, inv_mass,
                                                      x, y)
        logp = target - 0.5 * (rho * (inv_mass * rho)).sum(-1)
        w = logp - logp0
        leaf_div = ~(w > -DIVERGENCE_THRESHOLD)  # catches NaN too
        alpha = torch.clamp(torch.exp(w), max=1.0)
        alpha = torch.where(torch.isnan(alpha), 0.0, alpha)
        return theta, rho, target, grad, w, leaf_div, alpha

    def _checkpoint_turn(self, n, theta, rho, ckpt_theta, ckpt_rho, inv_mass):
        """Leaf ``n`` (a Python int): an even leaf stores (theta, rho) at slot
        popcount(n) and turns nowhere; an odd one is checked against the
        start leaves of the complete subtrees that end at it. Returns the
        per-chain turn [C] bool (the stores are in place)."""
        pc = int(_popcount(n))
        if n % 2 == 0:
            ckpt_theta[:, pc] = theta
            ckpt_rho[:, pc] = rho
            return torch.zeros_like(theta[:, 0], dtype=torch.bool)
        found = torch.zeros_like(theta[:, 0], dtype=torch.bool)
        for i in range(pc - int(_trailing_ones(n)), pc):
            found = found | _is_uturn(theta - ckpt_theta[:, i], inv_mass * ckpt_rho[:, i],
                                      inv_mass * rho)
        return found

    def _subtree_start(self, theta0, rho0, grad0):
        C, P = theta0.shape
        zeros = torch.zeros_like(theta0[:, 0])
        falses = torch.zeros_like(zeros, dtype=torch.bool)
        # a subtree never exceeds 2^(max_depth-1) leaves, so even-leaf slots
        # reach popcount max_depth - 2
        slots = max(self.max_depth - 1, 1)
        ckpt = (theta0.new_zeros((C, slots, P)), theta0.new_zeros((C, slots, P)))
        start = _Subtree(theta=theta0, rho=rho0, target=zeros, grad=grad0,
                         lse=torch.full_like(zeros, -math.inf), prop_theta=theta0,
                         prop_target=zeros, prop_grad=grad0, sum_alpha=zeros,
                         num_alpha=torch.zeros_like(zeros, dtype=torch.int32),
                         turning=falses, diverging=falses)
        return start, ckpt

    # ---- subtree of 2^depth leapfrog steps with checkpointed U-turn checks ----

    def _build_subtree(self, leaf_u, depth, theta0, rho0, grad0, step, inv_mass, logp0, x, y,
                       running):
        """Integrate up to ``2**depth`` steps from (theta0, rho0) for the
        chains in ``running`` [C] bool; a chain stops at its first U-turn or
        divergence and keeps its state from there (the other chains'
        fields are those of the start). ``leaf_u`` [C, 2**depth]: leaf n's
        multinomial uniform. Returns a ``_Subtree``: the last leaf (new end,
        local orientation), the proposal, the log-weight sum relative to
        logp0, the Metropolis statistics and the flags."""
        c, (ckpt_theta, ckpt_rho) = self._subtree_start(theta0, rho0, grad0)
        for n in range(2 ** depth):
            go = running & ~(c.turning | c.diverging)
            if not bool(go.any()):
                break
            theta, rho, target, grad, w, leaf_div, alpha = self._leaf(c, step, inv_mass,
                                                                      logp0, x, y)
            new_lse = torch.logaddexp(c.lse, w)
            take = torch.log(leaf_u[:, n]) < w - new_lse
            # a stopped chain's checkpoints are never read again
            found = self._checkpoint_turn(n, theta, rho, ckpt_theta, ckpt_rho, inv_mass)
            new = _Subtree(
                theta=theta, rho=rho, target=target, grad=grad, lse=new_lse,
                prop_theta=_where(take, theta, c.prop_theta),
                prop_target=_where(take, target, c.prop_target),
                prop_grad=_where(take, grad, c.prop_grad),
                sum_alpha=c.sum_alpha + alpha, num_alpha=c.num_alpha + 1,
                turning=c.turning | found, diverging=leaf_div)
            c = _select(go, new, c)
        return c

    # ---- fixed-budget subtree: every leapfrog runs, masked algebra ----

    def _build_subtree_fixed(self, leaf_u, depth, theta0, rho0, grad0, step, inv_mass, logp0,
                             x, y):
        """The contract of ``_build_subtree`` with all ``2**depth`` leapfrogs
        of every chain: after a chain's stop its leaves weigh -inf and its
        statistics and flags are gated, so the result equals the adaptive
        builder's (the end state is used only when the subtree is good, and
        then every leaf ran in both)."""
        c, (ckpt_theta, ckpt_rho) = self._subtree_start(theta0, rho0, grad0)
        for n in range(2 ** depth):
            live = ~(c.turning | c.diverging)
            theta, rho, target, grad, w, leaf_div, alpha = self._leaf(c, step, inv_mass,
                                                                      logp0, x, y)
            w_eff = torch.where(live, w, -math.inf)
            new_lse = torch.logaddexp(c.lse, w_eff)
            take = live & (torch.log(leaf_u[:, n]) < w_eff - new_lse)
            found = self._checkpoint_turn(n, theta, rho, ckpt_theta, ckpt_rho, inv_mass)
            c = _Subtree(
                theta=theta, rho=rho, target=target, grad=grad, lse=new_lse,
                prop_theta=_where(take, theta, c.prop_theta),
                prop_target=_where(take, target, c.prop_target),
                prop_grad=_where(take, grad, c.prop_grad),
                sum_alpha=c.sum_alpha + torch.where(live, alpha, 0.0),
                num_alpha=c.num_alpha + live.to(torch.int32),
                turning=c.turning | (live & found), diverging=c.diverging | (live & leaf_div))
        return c

    def _tree_start(self, sample, current_target, current_grad, rho0):
        zeros = torch.zeros_like(current_target)
        falses = torch.zeros_like(zeros, dtype=torch.bool)
        # the start state enters the multinomial pool with weight exp(0)
        return _Tree(theta_l=sample, r_l=rho0, grad_l=current_grad, theta_r=sample, r_r=rho0,
                     grad_r=current_grad, prop_theta=sample, prop_target=current_target,
                     prop_grad=current_grad, lse=zeros, sum_alpha=zeros,
                     num_alpha=torch.zeros_like(zeros, dtype=torch.int32), turning=falses,
                     diverging=falses, kept_depth=torch.zeros_like(zeros, dtype=torch.int32))

    def _merge(self, c, sub, depth, go_right, merge_u, inv_mass, active):
        """Merge a finished subtree into the trajectory of the chains in
        ``active`` (the doubling loop's body, after the subtree)."""
        bad = sub.turning | sub.diverging
        accept_log_prob = torch.minimum(sub.lse - c.lse, torch.zeros_like(c.lse))
        take = active & ~bad & (torch.log(merge_u) < accept_log_prob)
        ok = active & ~bad
        v = torch.where(go_right, 1.0, -1.0).to(sub.rho.dtype)[:, None]
        new_r = v * sub.rho  # forward-time momentum of the new end
        okr, okl = ok & go_right, ok & ~go_right
        theta_r = _where(okr, sub.theta, c.theta_r)
        r_r = _where(okr, new_r, c.r_r)
        theta_l = _where(okl, sub.theta, c.theta_l)
        r_l = _where(okl, new_r, c.r_l)
        whole_turn = ok & _is_uturn(theta_r - theta_l, inv_mass * r_l, inv_mass * r_r)
        return _Tree(
            theta_l=theta_l, r_l=r_l, grad_l=_where(okl, sub.grad, c.grad_l),
            theta_r=theta_r, r_r=r_r, grad_r=_where(okr, sub.grad, c.grad_r),
            prop_theta=_where(take, sub.prop_theta, c.prop_theta),
            prop_target=_where(take, sub.prop_target, c.prop_target),
            prop_grad=_where(take, sub.prop_grad, c.prop_grad),
            lse=torch.where(ok, torch.logaddexp(c.lse, sub.lse), c.lse),
            sum_alpha=c.sum_alpha + torch.where(active, sub.sum_alpha, 0.0),
            num_alpha=c.num_alpha + torch.where(active, sub.num_alpha, 0),
            turning=c.turning | (active & (bad | whole_turn)),
            diverging=c.diverging | (active & sub.diverging),
            kept_depth=torch.where(ok, depth + 1, c.kept_depth).to(torch.int32))

    def _tree(self, sample, current_target, current_grad, rho0, logp0, step, inv_mass, x, y,
              directions, leaf_uniforms, merge_uniforms):
        """The adaptive trajectory: doublings while any chain is live, each
        chain's ending at its first bad subtree or whole-trajectory U-turn."""
        c = self._tree_start(sample, current_target, current_grad, rho0)
        for depth in range(self.max_depth):
            active = ~(c.turning | c.diverging)
            if not bool(active.any()):
                break
            go_right = directions[:, depth]
            end_theta = _where(go_right, c.theta_r, c.theta_l)
            end_r = _where(go_right, c.r_r, -c.r_l)
            end_grad = _where(go_right, c.grad_r, c.grad_l)
            sub = self._build_subtree(leaf_uniforms[depth], depth, end_theta, end_r, end_grad,
                                      step, inv_mass, logp0, x, y, active)
            c = self._merge(c, sub, depth, go_right, merge_uniforms[:, depth], inv_mass, active)
        return c

    def _tree_fixed(self, sample, current_target, current_grad, rho0, logp0, step, inv_mass,
                    x, y, directions, leaf_uniforms, merge_uniforms):
        """The fixed-budget trajectory: every doubling of every chain, each
        level's merge gated by the chain's live flag before it, level for
        level the adaptive tree's result at ``2**max_depth - 1`` leapfrogs.
        ``directions`` [C, D] bool (True: right), ``leaf_uniforms`` D
        tensors [C, 2**d], ``merge_uniforms`` [C, D]."""
        c = self._tree_start(sample, current_target, current_grad, rho0)
        for depth in range(self.max_depth):
            active = ~(c.turning | c.diverging)
            go_right = directions[:, depth]
            end_theta = _where(go_right, c.theta_r, c.theta_l)
            end_r = _where(go_right, c.r_r, -c.r_l)
            end_grad = _where(go_right, c.grad_r, c.grad_l)
            sub = self._build_subtree_fixed(leaf_uniforms[depth], depth, end_theta, end_r,
                                            end_grad, step, inv_mass, logp0, x, y)
            c = self._merge(c, sub, depth, go_right, merge_uniforms[:, depth], inv_mass, active)
        return c

    # ---- one NUTS transition of every chain ----

    def step_fn(self, state, x, y, iteration, generator=None, momenta=None, directions=None,
                leaf_uniforms=None, merge_uniforms=None):
        """One transition of every chain at global iteration ``iteration``.
        The draws, each taken from ``generator`` unless given: ``momenta``
        [C, P] standard normals (scaled by sqrt(M)), ``directions`` [C, D]
        bool (True: double to the right), ``leaf_uniforms`` (D tensors [C,
        2**d]: leaf n of depth d's multinomial uniform) and ``merge_uniforms``
        [C, D], uniforms in [0, 1)."""
        sample = state.sample
        dtype, device = sample.dtype, sample.device
        C, D = sample.shape[0], self.max_depth
        if self.recompute_current:
            current_target, current_grad = self.upto_grad_log_target(sample, x, y)
        else:
            current_target, current_grad = state.target_val, state.grad_val

        def rand(*shape):
            return torch.rand(shape, generator=generator, dtype=dtype, device=device)

        if momenta is None:
            momenta = torch.randn(sample.shape, generator=generator, dtype=dtype, device=device)
        if directions is None:
            directions = rand(C, D) < 0.5
        if leaf_uniforms is None:
            leaf_uniforms = [rand(C, 2 ** d) for d in range(D)]
        if merge_uniforms is None:
            merge_uniforms = rand(C, D)

        inv_mass = state.inv_mass
        rho0 = momenta * torch.rsqrt(inv_mass)  # rho ~ N(0, M), M = diag(1 / inv_mass)
        logp0 = current_target - 0.5 * (rho0 * (inv_mass * rho0)).sum(-1)
        step = state.step[:, None]
        tree_fn = self._tree_fixed if self.fixed_budget else self._tree
        tree = tree_fn(sample, current_target, current_grad, rho0, logp0, step, inv_mass, x, y,
                       directions, leaf_uniforms, merge_uniforms)

        new_sample = tree.prop_theta
        accepted = torch.any(new_sample != sample, dim=-1).to(torch.int32)
        accept_stat = tree.sum_alpha / torch.clamp(tree.num_alpha, min=1).to(dtype)

        new_tuner, new_step = state.tuner, state.step
        if self.tuner is not None and iteration < self.num_burnin_iters:
            return_e = iteration != self.num_burnin_iters - 1
            new_tuner, new_step, _ = self.tuner.tune(state.tuner, accept_stat, iteration,
                                                     return_e)

        # diagonal metric warmup (Welford over burn-in samples)
        new_inv_mass = state.inv_mass
        wf_mean, wf_m2, wf_n = state.wf_mean, state.wf_m2, state.wf_n
        if self.mass_adapt and self.num_burnin_iters >= 20:
            warm_start = self.num_burnin_iters // 4
            freeze_at = self.num_burnin_iters // 2
            if warm_start <= iteration < freeze_at:
                n_new = wf_n + 1
                delta = new_sample - wf_mean
                wf_mean = wf_mean + delta / n_new.to(dtype)[:, None]
                wf_m2 = wf_m2 + delta * (new_sample - wf_mean)
                wf_n = n_new
            if iteration == freeze_at - 1:
                n_f = torch.clamp(wf_n, min=2).to(dtype)[:, None]
                var = wf_m2 / (n_f - 1.0)
                # Stan's shrinkage toward the unit metric for short windows
                var_reg = (n_f / (n_f + 5.0)) * var + 1e-3 * (5.0 / (n_f + 5.0))
                usable = wf_n > 1
                new_inv_mass = _where(usable, torch.clamp(var_reg, min=1e-10), new_inv_mass)
                if self.tuner is not None:
                    # dual-averaging warm restart against the new metric
                    fresh = self.tuner.init(new_step, dtype=dtype, device=device)
                    new_tuner = _select(usable, fresh, new_tuner)

        new_state = NUTSState(
            sample=new_sample, target_val=tree.prop_target, grad_val=tree.prop_grad,
            accepted=accepted, accept_stat=accept_stat, depth=tree.kept_depth,
            num_leapfrogs=tree.num_alpha, divergent=tree.diverging.to(torch.int32),
            step=new_step, inv_mass=new_inv_mass, wf_mean=wf_mean, wf_m2=wf_m2, wf_n=wf_n,
            tuner=new_tuner)
        info = {k: getattr(new_state, k) for k in self.state_keys}
        return new_state, info
