"""Plain HMC: one transition from given states and draws, the population
dual averaging of a tuning group's burn-in, and the fit of a group's frozen
step to the transitions a run recorded.

The transition: p = m + (e/2) g(theta); then n times theta += e p and
p += e g(theta), the last momentum step halved; accept when the uniform u
is below min(1, exp(H(start) - H(end))), H = -log posterior + |p|^2/2.

The tuner (an HMC dual-averaging tuner with the l-rule): at burn-in
iteration t (it = t + 1), on the mean acceptance rate r of a group,
h <- (1 - 1/(it + t0)) h + (d - r)/(it + t0); log e = min(m - sqrt(it) h / g,
log eub) with m = log(10 e_0); log ebar <- it^-k log e + (1 - it^-k) log
ebar; the step is e, and after the last burn-in iteration ebar, frozen with
n = clamp(round(l / e), 1, max_num_steps) leapfrog steps.
"""

import math

import torch

from reference import threefry


def leapfrog(vg, theta, mom, step, n_steps, val=None, grad=None):
    """(end theta, end momentum, end value, start value) of ``n_steps[b]``
    leapfrog steps of size ``step[b]`` from ``theta`` [B, P], ``mom``
    [B, P]."""
    if val is None:
        val, grad = vg(theta)
    start_val = val
    e = step[:, None]
    th, p, v, g = theta, mom + 0.5 * e * grad, val, grad
    for s in range(int(n_steps.max()) if theta.shape[0] else 0):
        active = (s < n_steps)[:, None]
        th_s = th + e * p
        v_s, g_s = vg(th_s)
        f = torch.where(n_steps - 1 == s, 0.5, 1.0).to(theta.dtype)[:, None] * e
        th = torch.where(active, th_s, th)
        p = torch.where(active, p + f * g_s, p)
        v = torch.where(active[:, 0], v_s, v)
        g = torch.where(active, g_s, g)
    return th, p, v, start_val, g


def transition(vg, theta, mom, u_accept, step, n_steps):
    """One HMC transition of each row: (proposal [B, P], accept [B] bool,
    margin [B]: |log u - log rate|, how far the accept test lay from its
    threshold)."""
    th, p, v, start_val, _ = leapfrog(vg, theta, mom, step, n_steps)
    h_cur = -start_val + 0.5 * torch.sum(mom * mom, dim=1)
    h_prop = -v + 0.5 * torch.sum(p * p, dim=1)
    log_rate = torch.clamp(h_cur - h_prop, max=0.0)
    log_u = torch.log(u_accept)
    accept = log_u < log_rate
    margin = torch.abs(log_u - log_rate)
    margin = torch.where(torch.isnan(margin), math.inf, margin)
    return th, accept, margin


def group_tune(t, tuner, m, barh, logbare, mean_rate, last):
    """One dual-averaging update of every group: (barh, logbare, step)."""
    it = float(t + 1)
    d_w = 1.0 / (it + tuner["t0"])
    e_w = it ** -tuner["k"]
    barh = (1.0 - d_w) * barh + d_w * (tuner["d"] - mean_rate)
    loge = m - math.sqrt(it) * barh / tuner["g"]
    if tuner.get("eub") is not None:
        loge = torch.clamp(loge, max=math.log(tuner["eub"]))
    logbare = e_w * loge + (1.0 - e_w) * logbare
    return barh, logbare, torch.exp(logbare) if last else torch.exp(loge)


def tuned_burnin(vg, seed, theta0, chains, groups, settings, dtype):
    """The burn-in of whole tuning groups: ``theta0`` [B, P] the starts of
    chains ``chains`` [B] (global indices), ``groups`` [B] each chain's group
    (0..G-1, rows of one group together). Returns (the frozen step [G], its
    leapfrog steps [G], the evaluations a chain of each group made [G])."""
    tuner = settings["tuner"]
    G = int(groups.max()) + 1
    B, P = theta0.shape
    f = dict(dtype=dtype, device=theta0.device)
    step0 = float(settings["step"])
    m = math.log(10.0 * step0)
    step = torch.full((B,), step0, **f)
    n_steps = torch.full((B,), int(settings["num_steps"]), dtype=torch.int64,
                         device=theta0.device)
    barh = torch.zeros(G, **f)
    logbare = torch.zeros(G, **f)
    counts = torch.zeros(G, **f)
    counts.index_add_(0, groups, torch.ones(B, **f))
    evaluations = torch.ones(G, **f)
    theta = theta0.to(dtype)
    val, grad = vg(theta)
    burnin = int(settings["num_burnin_iters"])
    for t in range(burnin):
        mom, u, _ = threefry.hmc_draws(seed, chains, torch.full_like(chains, t), P)
        mom = mom.T.to(dtype)
        evaluations += torch.zeros(G, **f).index_add_(0, groups, n_steps.to(dtype)) / counts
        th, p, v, _, g = leapfrog(vg, theta, mom, step, n_steps, val, grad)
        h_cur = -val + 0.5 * torch.sum(mom * mom, dim=1)
        h_prop = -v + 0.5 * torch.sum(p * p, dim=1)
        rate = torch.clamp(torch.exp(h_cur - h_prop), max=1.0)
        accept = u.to(dtype) < rate
        theta = torch.where(accept[:, None], th, theta)
        val = torch.where(accept, v, val)
        grad = torch.where(accept[:, None], g, grad)
        mean_rate = torch.zeros(G, **f).index_add_(0, groups, rate) / counts
        barh, logbare, new_step = group_tune(t, tuner, m, barh, logbare, mean_rate,
                                             t == burnin - 1)
        step = new_step[groups]
        n_steps = torch.clamp(torch.round(tuner["l"] / new_step), 1,
                              settings["max_num_steps"]).to(torch.int64)[groups]
    frozen = torch.zeros(G, **f).index_add_(0, groups, step) / counts
    n_frozen = torch.clamp(torch.round(tuner["l"] / frozen), 1, settings["max_num_steps"])
    return frozen, n_frozen.to(torch.int64), evaluations


def fit_step(vg, starts, ends, mom, fit_group, num_groups, l, max_num_steps, iters=10):
    """Each group's frozen step and leapfrog count, fitted to accepted
    transitions the run recorded: ``starts``, ``ends``, ``mom`` [M, P] with
    ``fit_group`` [M]. Every count n in 1..max_num_steps is tried with steps
    e in (l/(n + 1/2), l/(n - 1/2)] (round(l/e) = n), by Gauss-Newton on e
    from l/n; the pair whose trajectories land nearest the recorded ends wins.
    Returns (step [G], n [G], residual [G]: the largest coordinate distance
    left, inf for a group with no transition)."""
    dtype, device = starts.dtype, starts.device
    if starts.shape[0] == 0:
        return (torch.zeros(num_groups, dtype=dtype, device=device),
                torch.ones(num_groups, dtype=torch.int64, device=device),
                torch.full((num_groups,), math.inf, dtype=dtype, device=device))
    ns = torch.arange(1, max_num_steps + 1, device=device)
    N = ns.numel()
    M = starts.shape[0]
    # rows: every (transition, candidate n)
    rows_n = ns.repeat(M)
    rows_m = torch.arange(M, device=device).repeat_interleave(N)
    lo = l / (rows_n.to(dtype) + 0.5)
    hi = torch.where(rows_n == 1, torch.full_like(lo, math.inf), l / (rows_n.to(dtype) - 0.5))
    lo = torch.where(rows_n == max_num_steps, torch.zeros_like(lo), lo)
    s = torch.clamp(l / rows_n.to(dtype), min=lo, max=hi)
    th0, p0, target = starts[rows_m], mom[rows_m], ends[rows_m]
    val0, grad0 = vg(th0)
    both_th0, both_p0 = torch.cat([th0, th0]), torch.cat([p0, p0])
    both_val, both_grad = torch.cat([val0, val0]), torch.cat([grad0, grad0])
    both_n = torch.cat([rows_n, rows_n])
    # one Gauss-Newton fit per (group, n) over that group's transitions
    key = fit_group[rows_m] * N + (rows_n - 1)
    for _ in range(iters):
        h = s * 1e-7
        both_s = torch.cat([s, s + h])
        end, *_ = leapfrog(vg, both_th0, both_p0, both_s, both_n, both_val, both_grad)
        r = end[:len(s)] - target
        jac = (end[len(s):] - end[:len(s)]) / h[:, None]
        num = torch.zeros(num_groups * N, dtype=dtype, device=device).index_add_(
            0, key, torch.sum(jac * r, dim=1))
        den = torch.zeros(num_groups * N, dtype=dtype, device=device).index_add_(
            0, key, torch.sum(jac * jac, dim=1))
        delta = -(num / torch.clamp(den, min=1e-300))[key]
        s = torch.clamp(s + delta, min=lo, max=hi)
        s = torch.where(torch.isfinite(s), s, l / rows_n.to(dtype))
    end, *_ = leapfrog(vg, th0, p0, s, rows_n, val0, grad0)
    resid = torch.amax(torch.abs(end - target), dim=1)
    worst = torch.full((num_groups * N,), -math.inf, dtype=dtype, device=device)
    worst = worst.scatter_reduce(0, key, resid, reduce="amax")
    seen = torch.zeros(num_groups * N, dtype=torch.bool, device=device)
    seen[key] = True
    worst = torch.where(seen, worst, torch.full_like(worst, math.inf)).reshape(num_groups, N)
    best = torch.argmin(worst, dim=1)
    step_of = torch.zeros(num_groups * N, dtype=dtype, device=device)
    step_of[key] = s
    step_of = step_of.reshape(num_groups, N)
    g = torch.arange(num_groups, device=device)
    return step_of[g, best], ns[best], worst[g, best]
