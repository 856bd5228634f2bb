"""Plain MALA: one transition from given states and draws, and a run of
whole iterations from the starts (the burn-in).

The proposal is theta + (e/2) g(theta) + sqrt(e) z; it is accepted when
log u < log p(prop) - log p(theta) - |theta - prop - (e/2) g(prop)|^2 / (2e)
+ |z|^2 / 2.
"""

import math

import torch

from reference import threefry


def _propose(vg, theta, val, grad, z, step):
    half, sq = 0.5 * step, math.sqrt(step)
    prop = theta + half * grad + sq * z
    v_p, g_p = vg(prop)
    d_rev = theta - (prop + half * g_p)
    log_rate = (v_p - val) - (0.5 / step) * torch.sum(d_rev * d_rev, dim=1) \
        + 0.5 * torch.sum(z * z, dim=1)
    return prop, v_p, g_p, log_rate


def transition(vg, theta, z, u, step):
    """(proposal [B, P], accept [B], margin [B] = |log u - log rate|)."""
    val, grad = vg(theta)
    prop, _, _, log_rate = _propose(vg, theta, val, grad, z, step)
    log_u = torch.log(u)
    accept = log_u < log_rate
    margin = torch.abs(log_u - log_rate)
    return prop, accept, torch.where(torch.isnan(margin), math.inf, margin)


def run(vg, seed, theta0, chains, first, count, step, dtype):
    """Iterations first .. first + count - 1 of the chains ``chains`` from
    ``theta0`` [B, P]: the state after the last."""
    theta = theta0.to(dtype)
    val, grad = vg(theta)
    P = theta.shape[1]
    for t in range(first, first + count):
        z, u = threefry.walk_draws(seed, chains, torch.full_like(chains, t), P)
        prop, v_p, g_p, log_rate = _propose(vg, theta, val, grad, z.T.to(dtype), step)
        accept = torch.log(u.to(dtype)) < log_rate
        theta = torch.where(accept[:, None], prop, theta)
        val = torch.where(accept, v_p, val)
        grad = torch.where(accept[:, None], g_p, grad)
    return theta
