"""Plain fixed-budget NUTS with multinomial sampling, after the whole-loop
kernels' definition: one transition from given states and draws, and the
dual-averaged burn-in of whole tuning groups.

A transition doubles the trajectory D times, each time to the side the
direction uniform picks (right when u < 1/2); a subtree of 2^d leaves is
built by leapfrog from the chosen end, each live leaf taken as the
subtree's candidate when log u_leaf < w - logsumexp(w of the subtree so
far), with w = H(start) - H(leaf); a leaf with w <= -1000 diverges; the
U-turn test of the subtree's checkpoints and of the whole trajectory stops
the doubling; a sound subtree's candidate replaces the proposal when log
u_merge < min(0, lse(subtree) - lse(trajectory)). The accept statistic is
the mean of min(1, exp w) over the live leaves; the tuner is the dual
averaging of ``reference.hmc`` on each group's mean statistic. A leaf after
a U-turn or a divergence is not live: it changes neither the proposal nor
the statistic, so the work a transition needs is counted over its live
leaves, the U-turn tests on live leaves and the subtrees merged.
"""

import math

import torch

from reference import threefry
from reference.hmc import group_tune

DIVERGENCE_THRESHOLD = 1000.0


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    r = m + torch.log1p(torch.exp(-torch.abs(a - b)))
    return torch.where(m == -math.inf, m, r)


def transition(vg, theta, val, grad, draws, step, depth, margins=True, counts=None):
    """One transition of each row of ``theta`` [B, P] (with its value [B]
    and gradient [B, P]) at steps ``step`` [B]: (proposal, its value, its
    gradient, accept statistic [B], log-margin [B]: the least distance of a
    uniform from its threshold, turn-margin [B]: the least |<a, b>|/(|a||b|)
    of a U-turn test; both None without ``margins``). ``counts``, a dict,
    gets each row's live leaves, U-turn tests and merges [B] added to its
    "leaves", "checks" and "merges"."""
    z, dirs, leaf_u, merge_u = draws
    B, P = theta.shape
    dt = theta.dtype
    f = dict(dtype=dt, device=theta.device)
    e = step[:, None]
    neg_inf = torch.full((B,), -math.inf, **f)
    falses = torch.zeros(B, dtype=torch.bool, device=theta.device)
    zeros = torch.zeros(B, **f)
    inf = torch.full((B,), math.inf, **f)
    log_margin, turn_margin = inf, inf
    checks, merges = zeros, zeros

    def uturn(dtheta, r_left, r_right, live):
        nonlocal turn_margin, checks
        checks = checks + live.to(dt)
        out = falses
        for r in (r_left, r_right):
            dot = torch.sum(dtheta * r, dim=1)
            if margins:
                rel = torch.abs(dot) / (torch.linalg.vector_norm(dtheta, dim=1)
                                        * torch.linalg.vector_norm(r, dim=1) + 1e-300)
                turn_margin = torch.where(live, torch.fmin(turn_margin, rel), turn_margin)
            out = out | (dot < 0.0)
        return out

    mom = z
    logp0 = val - 0.5 * torch.sum(mom * mom, dim=1)
    th_l = th_r = theta
    r_l = r_r = mom
    g_l = g_r = grad
    prop_t, prop_v, prop_g = theta, val, grad
    lse, sum_alpha, num_alpha = zeros, zeros, zeros
    turning = diverging = falses
    for d in range(depth):
        active = ~(turning | diverging)
        go_right = (dirs[d] < 0.5)[:, None]
        th = torch.where(go_right, th_r, th_l)
        rho = torch.where(go_right, r_r, -r_l)
        g = torch.where(go_right, g_r, g_l)
        s_lse, s_sum, s_num = neg_inf, zeros, zeros
        s_t, s_v, s_g = th, zeros, g
        s_turn = s_div = falses
        ckpt = [None] * max(depth - 1, 1)
        for n in range(1 << d):
            live = active & ~(s_turn | s_div)
            rho = rho + 0.5 * e * g
            th = th + e * rho
            v, g = vg(th)
            rho = rho + 0.5 * e * g
            w = (v - 0.5 * torch.sum(rho * rho, dim=1)) - logp0
            leaf_div = ~(w > -DIVERGENCE_THRESHOLD)
            alpha = torch.clamp(torch.exp(w), max=1.0)
            alpha = torch.where(torch.isnan(alpha), 0.0, alpha)
            w_eff = torch.where(live, w, -math.inf)
            new_lse = _logaddexp(s_lse, w_eff)
            threshold = w_eff - new_lse
            log_u = torch.log(leaf_u[d][n])
            take = live & (log_u < threshold)
            if margins:
                # the first live leaf of a subtree is always taken (threshold 0)
                first_leaf = live & (s_lse == -math.inf)
                m = torch.abs(log_u - threshold)
                log_margin = torch.where(live & ~first_leaf & torch.isfinite(m),
                                         torch.fmin(log_margin, m), log_margin)
                dm = torch.abs(w + DIVERGENCE_THRESHOLD)
                log_margin = torch.where(live, torch.fmin(log_margin, dm), log_margin)
            s_t = torch.where(take[:, None], th, s_t)
            s_v = torch.where(take, v, s_v)
            s_g = torch.where(take[:, None], g, s_g)
            s_lse = new_lse
            pc = bin(n).count("1")
            if n % 2 == 0:
                ckpt[pc] = (th, rho)
            else:
                trailing = (n ^ (n + 1)).bit_length() - 1
                found = falses
                for i in range(pc - trailing, pc):
                    found = found | uturn(th - ckpt[i][0], ckpt[i][1], rho, live)
                s_turn = s_turn | (live & found)
            s_div = s_div | (live & leaf_div)
            s_sum = s_sum + torch.where(live, alpha, 0.0)
            s_num = s_num + live.to(dt)
        bad = s_turn | s_div
        merges = merges + active.to(dt)
        sum_alpha = sum_alpha + torch.where(active, s_sum, 0.0)
        num_alpha = num_alpha + torch.where(active, s_num, 0.0)
        accept_log_prob = torch.minimum(s_lse - lse, zeros)
        log_mu = torch.log(merge_u[d])
        take = active & ~bad & (log_mu < accept_log_prob)
        if margins:
            m = torch.abs(log_mu - accept_log_prob)
            log_margin = torch.where(active & ~bad & torch.isfinite(m),
                                     torch.fmin(log_margin, m), log_margin)
        prop_t = torch.where(take[:, None], s_t, prop_t)
        prop_v = torch.where(take, s_v, prop_v)
        prop_g = torch.where(take[:, None], s_g, prop_g)
        ok = active & ~bad
        lse = torch.where(ok, _logaddexp(lse, s_lse), lse)
        okr, okl = (ok & go_right[:, 0])[:, None], (ok & ~go_right[:, 0])[:, None]
        new_r = torch.where(go_right, rho, -rho)
        th_r = torch.where(okr, th, th_r)
        r_r = torch.where(okr, new_r, r_r)
        g_r = torch.where(okr, g, g_r)
        th_l = torch.where(okl, th, th_l)
        r_l = torch.where(okl, new_r, r_l)
        g_l = torch.where(okl, g, g_l)
        whole_turn = ok & uturn(th_r - th_l, r_l, r_r, ok)
        turning = turning | (active & (bad | whole_turn))
        diverging = diverging | (active & s_div)
    accept_stat = sum_alpha / torch.clamp(num_alpha, min=1.0)
    if counts is not None:
        for key, n in (("leaves", num_alpha), ("checks", checks), ("merges", merges)):
            counts[key] = counts.get(key, 0.0) + n.double()
    if not margins:
        log_margin = turn_margin = None
    return prop_t, prop_v, prop_g, accept_stat, log_margin, turn_margin


def draws_as_rows(draws, dtype):
    z, dirs, leaves, merges = draws
    return (z.T.to(dtype), dirs, [u.to(dtype) for u in leaves], merges.to(dtype))


def tuned_burnin(vg, seed, theta0, chains, groups, settings, dtype):
    """The burn-in of whole tuning groups (rows of ``theta0`` [B, P], their
    global chain indices ``chains`` and groups ``groups``): (the frozen step
    of each group [G], each row's live leaves, U-turn tests and merges over
    the burn-in, {"leaves", "checks", "merges"} of [B])."""
    tuner = settings["tuner"]
    depth = int(settings["max_depth"])
    G = int(groups.max()) + 1
    B, P = theta0.shape
    f = dict(dtype=dtype, device=theta0.device)
    step0 = float(settings["step"])
    # the NUTS kernels take m = log(10 e_0) rounded to float32
    m = float(torch.tensor(math.log(10.0 * step0), dtype=torch.float32))
    step = torch.full((B,), step0, **f)
    barh = torch.zeros(G, **f)
    logbare = torch.zeros(G, **f)
    members = torch.zeros(G, **f).index_add_(0, groups, torch.ones(B, **f))
    theta = theta0.to(dtype)
    val, grad = vg(theta)
    burnin = int(settings["num_burnin_iters"])
    counts = {}
    for t in range(burnin):
        draws = threefry.nuts_draws(seed, chains, torch.full_like(chains, t), P, depth)
        theta, val, grad, stat, _, _ = transition(vg, theta, val, grad,
                                                  draws_as_rows(draws, dtype), step, depth,
                                                  margins=False, counts=counts)
        mean_stat = torch.zeros(G, **f).index_add_(0, groups, stat) / members
        mean_stat = torch.where(torch.isnan(mean_stat), 0.0, mean_stat)
        barh, logbare, new_step = group_tune(t, tuner, m, barh, logbare, mean_stat,
                                             t == burnin - 1)
        step = new_step[groups]
    return torch.zeros(G, **f).index_add_(0, groups, step) / members, counts
