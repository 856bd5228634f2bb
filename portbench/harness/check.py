"""Decides ``correct``: the program's outputs against the plain reference.

The timed path is ``sample_chains`` ending in a ``ChainLists``. Once the
window has closed, a sample of the last call's chains, drawn from the seed,
is replayed transition by transition: from each recorded state (the
benchmark's own start for the first iteration of a run without burn-in),
with the draws the kernel's stream gives that chain and iteration
(``reference/threefry.py``), the reference makes the same transition in
float64 and its outcome (the proposal where it accepts, the start where it
rejects) must be the recorded next state. Where the reference's accept test
lies within ``tie_log`` of its threshold, float32 rounding may decide it
either way and both outcomes stand. The numbers:

- ``launches``: window calls that did not make exactly one launch of the
  cell's kernel and none of another whole-loop kernel (dispatch);
- ``layout``: 1 where the ``ChainLists`` does not hold ``sample`` [C, kept,
  P] and ``accepted`` [C, kept] (the re-layout);
- ``flags``: recorded accept flags that disagree with whether the sample
  moved (and, without burn-in, with the reference's first decision);
- ``gap``: the largest coordinate distance of a recorded state from its
  reference outcome (the kernel's samples and decisions);
- ``step_gap``: where the cell tunes, the tuner's hand-off: the program's
  frozen step against the step of the reference's own replay of whole
  groups' burn-in from the benchmark's starts. For HMC, |the mean over the
  replayed groups of the log ratio| of a group's step fitted to the recorded
  transitions to the reference's (each group's replay parts from the
  program's on a chaotic burn-in, so one group of 256 swings by a percent
  or so either way); for NUTS, whose groups of 8192 average the chaos away,
  the largest |log ratio| of any chain's step (the kernel's ``last_info``)
  to its group's, over every group the cell names;
- ``burnin_gap``: where an untuned burn-in precedes the kept iterations
  (MALA's), the lower quartile over the sampled chains of the distance of
  the reference's replay of the burn-in and the first kept iteration, from
  the benchmark's starts, to the recorded first state. The burn-in is
  chaotic: about half of the float64 replays part from the float32 program
  (as they part from a float64 replay one float32 ulp away), the other half
  follow it to rounding; the lower quartile lies among those.
The control runs the same replay with the reference in bfloat16 in the
program's place and reads the same numbers. The replay also counts the work
the inputs needed where it depends on the run (NUTS's live leaves).
"""

import math

import torch

from reference import hmc, mala, nuts, threefry
from reference.mlp import MLPPosterior

CHUNK = 16384


def _nan_inf(t):
    return torch.where(torch.isnan(t), math.inf, t)


def group_of(chains, C, spec):
    """Each chain's tuning group under the cell's layout."""
    cb = spec["tuning_group"]
    if spec["group_layout"] == "block":
        return chains // cb
    sl = spec["sublanes"]
    return (chains % (C // sl)) // (cb // sl)


def group_members(g, C, spec):
    cb = spec["tuning_group"]
    if spec["group_layout"] == "block":
        return torch.arange(g * cb, (g + 1) * cb)
    sl = spec["sublanes"]
    lb = cb // sl
    s = torch.arange(sl)[:, None] * (C // sl)
    j = g * lb + torch.arange(lb)[None, :]
    return (s + j).reshape(-1)


def select(spec, C, seed):
    """(sampled chains [K] sorted, burn-in groups [G_b]) drawn from the seed."""
    gen = torch.Generator().manual_seed((int(seed) * 2654435761 + 97) % 2 ** 63)
    burnin_groups = torch.zeros(0, dtype=torch.int64)
    if "groups" in spec:  # tuned HMC: whole groups, a few chains of each
        G = C // spec["tuning_group"]
        groups = torch.randperm(G, generator=gen)[:spec["groups"]]
        chains = torch.cat([group_members(int(g), C, spec)[
            torch.randperm(spec["tuning_group"], generator=gen)[:spec["chains_per_group"]]]
            for g in groups])
        burnin_groups = groups[:spec["burnin_groups"]]
    else:
        chains = torch.randperm(C, generator=gen)[:spec["chains"]]
        if "tuning_group" in spec:
            G = C // spec["tuning_group"]
            burnin_groups = torch.randperm(G, generator=gen)[:spec["burnin_groups"]]
    return torch.sort(chains).values, burnin_groups


class Inputs:
    """What the check reads of one call: the sampled chains' recorded
    samples [K, kept, P] and flags [K, kept] (float64 and int on the
    device), whether the ``ChainLists`` layout held, the kernel seed, the
    benchmark's starts [C, P], the data, and the program's per-chain steps
    where the kernel reports them."""

    def __init__(self, chain_lists, chains, burnin_groups, C, kept, P, seed, theta0s, x, y,
                 steps=None):
        samples = chain_lists.tensor("sample")
        flags = chain_lists.tensor("accepted")
        self.layout_ok = (samples is not None and flags is not None
                          and tuple(samples.shape) == (C, kept, P)
                          and tuple(flags.shape) == (C, kept))
        idx = chains.to(samples.device)
        self.samples = samples[idx].to(torch.float64)
        self.flags = flags[idx].to(torch.int64)
        self.chains = chains.to(samples.device)
        self.burnin_groups = burnin_groups
        self.seed = seed
        self.theta0s = theta0s
        self.x, self.y = x, y
        # NUTS: the kernel's per-chain frozen steps [C], and the sampled ones
        self.steps_all = steps
        self.steps = None if steps is None else steps[idx].to(torch.float64)


def _replay(kind, post, seed, starts, chains, iters, step, n_steps, depth, dtype, counts=None):
    """The reference's transitions of rows (starts [B, P], global chains
    [B], iterations [B], steps [B]): (proposals [B, P] float64, accept [B],
    margin [B]) in chunks; NUTS's accept is None and its margin the pair
    (log-margin, turn-margin) of ``nuts.transition``, and the work of all
    rows is summed into ``counts`` (floats)."""
    P = starts.shape[1]
    outs = []
    for lo in range(0, starts.shape[0], CHUNK):
        sl = slice(lo, lo + CHUNK)
        th = starts[sl].to(dtype)
        if kind == "hmc":
            mom, u, _ = threefry.hmc_draws(seed, chains[sl], iters[sl], P)
            prop, acc, margin = hmc.transition(post.vg, th, mom.T.to(dtype), u.to(dtype),
                                               step[sl].to(dtype), n_steps[sl])
        elif kind == "mala":
            z, u = threefry.walk_draws(seed, chains[sl], iters[sl], P)
            prop, acc, margin = mala.transition(post.vg, th, z.T.to(dtype), u.to(dtype),
                                                float(step[0]))
        else:
            draws = threefry.nuts_draws(seed, chains[sl], iters[sl], P, depth)
            val, grad = post.vg(th)
            rows = None if counts is None else {}
            prop, _, _, _, lm, tm = nuts.transition(post.vg, th, val, grad,
                                                    nuts.draws_as_rows(draws, dtype),
                                                    step[sl].to(dtype), depth, counts=rows)
            for key, n in (rows or {}).items():
                counts[key] = counts.get(key, 0.0) + float(n.sum())
            acc, margin = None, (lm, tm)
        outs.append((prop.to(torch.float64), acc, margin))
    prop = torch.cat([o[0] for o in outs])
    if kind == "nuts":
        return prop, None, (torch.cat([o[2][0] for o in outs]).double(),
                            torch.cat([o[2][1] for o in outs]).double())
    return prop, torch.cat([o[1] for o in outs]), torch.cat([o[2] for o in outs]).double()


class Judge:
    """Runs the check of one cell on one call's ``Inputs``."""

    def __init__(self, cell, traffic, spec, device):
        self.cell, self.traffic, self.spec = cell, traffic, spec
        self.kind = spec["kind"]
        self.device = device
        self.C, self.burnin = traffic["chains"], traffic["burnin"]
        self.settings = dict(traffic["args"], tuner=traffic["tuner"],
                             num_burnin_iters=self.burnin)
        self.depth = int(traffic["args"].get("max_depth", 0))

    def posterior(self, inputs, dtype):
        return MLPPosterior(self.cell.config, inputs.x, inputs.y, dtype, self.device)

    def _rows(self, inp):
        """The transitions to replay: (starts, ends, chains, iterations,
        kept index) of every sampled chain's kept iterations that start
        from a known state."""
        K, kept, P = inp.samples.shape
        first = 0 if self.burnin == 0 else 1
        ks = torch.arange(first, kept, device=inp.samples.device)
        ends = inp.samples[:, first:, :]
        if first == 0:
            t0 = inp.theta0s[inp.chains].to(torch.float64)[:, None, :]
            starts = torch.cat([t0, inp.samples[:, :-1, :]], dim=1)
        else:
            starts = inp.samples[:, :-1, :]
        chains = inp.chains[:, None].expand(-1, ks.numel())
        iters = (self.burnin + ks)[None, :].expand(K, -1)
        return (starts.reshape(-1, P), ends.reshape(-1, P), chains.reshape(-1),
                iters.reshape(-1), ks[None, :].expand(K, -1).reshape(-1))

    def _steps(self, inp, post, chains_rows, starts, ends, ks):
        """Each row's step and leapfrog count, with what the check learnt
        of the groups (fitted steps, residuals)."""
        B = chains_rows.shape[0]
        f64 = dict(dtype=torch.float64, device=starts.device)
        args = self.traffic["args"]
        if self.kind == "mala":
            return torch.full((B,), float(args["step"]), **f64), None, {}
        if self.kind == "nuts":
            pos = torch.searchsorted(inp.chains, chains_rows)
            return inp.steps[pos], None, {}
        if self.traffic["tuner"] is None:
            return (torch.full((B,), float(args["step"]), **f64),
                    torch.full((B,), int(args["num_steps"]), dtype=torch.int64,
                               device=starts.device), {})
        groups = group_of(chains_rows, self.C, self.spec)
        uniq, local = torch.unique(groups, return_inverse=True)
        moved = torch.any(ends != starts, dim=1)
        # up to four moved transitions of each group fix its step
        pick = []
        for g in range(uniq.numel()):
            rows = torch.nonzero(moved & (local == g)).reshape(-1)
            pick.append(rows[torch.linspace(0, rows.numel() - 1, min(4, rows.numel()),
                                            device=rows.device).long()] if rows.numel() else rows)
        pick = torch.cat(pick)
        P = starts.shape[1]
        mom, _, _ = threefry.hmc_draws(inp.seed, chains_rows[pick],
                                       self.burnin + ks[pick], P)
        step_g, n_g, resid = hmc.fit_step(post.vg, starts[pick], ends[pick],
                                          mom.T.to(torch.float64), local[pick], uniq.numel(),
                                          float(self.traffic["tuner"]["l"]),
                                          int(args["max_num_steps"]))
        info = {"groups": uniq, "step": step_g, "n": n_g, "residual": resid}
        return step_g[local], n_g[local], info

    def run(self, inp, control=False, launches=None):
        """{number: value} of the program (or, ``control``, of the reference
        in bfloat16 in its place), and what was learnt on the way."""
        numbers, learnt = {}, {}
        if launches is not None:
            numbers["launches"] = launches
        numbers["layout"] = 0 if inp.layout_ok else 1
        post = self.posterior(inp, torch.float64)
        starts, ends, chains, iters, ks = self._rows(inp)
        step, n_steps, learnt = self._steps(inp, post, chains, starts, ends, ks)
        work = {}
        prop, acc, margin = _replay(self.kind, post, inp.seed, starts, chains, iters, step,
                                    n_steps, self.depth, torch.float64, counts=work)
        # the work of a kept transition, on average
        learnt["kept_work"] = {k: v / max(starts.shape[0], 1) for k, v in work.items()}
        outcome = ends
        if control:
            post_c = self.posterior(inp, torch.bfloat16)
            prop_c, acc_c, _ = _replay(self.kind, post_c, inp.seed, starts, chains, iters, step,
                                       n_steps, self.depth, torch.bfloat16)
            outcome = prop_c if acc_c is None else torch.where(acc_c[:, None], prop_c, starts)
        d_acc = _nan_inf(torch.amax(torch.abs(outcome - prop), dim=1))
        if self.kind == "nuts":
            log_m, turn_m = margin
            tied = (log_m < self.spec["tie_log"]) | (turn_m < self.spec["tie_dot"])
            gaps = torch.where(tied, 0.0, d_acc)
        else:
            d_rej = _nan_inf(torch.amax(torch.abs(outcome - starts), dim=1))
            tied = margin < self.spec["tie_log"]
            gaps = torch.where(tied, torch.minimum(d_acc, d_rej), torch.where(acc, d_acc, d_rej))
        learnt["tied_share"] = float(tied.double().mean())
        numbers["gap"] = float(gaps.max()) if gaps.numel() else math.inf
        if "residual" in learnt:  # a group whose frozen step no trajectory fits
            numbers["gap"] = max(numbers["gap"], float(_nan_inf(learnt["residual"]).max()))
        learnt["transitions"] = int(gaps.numel())
        if not control:
            numbers["flags"] = self._flags(inp, acc, tied, ks)
        if "step_gap" in self.cell.spec["limits"]:
            numbers["step_gap"], more = self._step_gap(inp, learnt, control)
            learnt.update(more)
        if "burnin_gap" in self.cell.spec["limits"]:
            numbers["burnin_gap"] = float(torch.quantile(
                self._burnin_miss(inp, torch.bfloat16 if control else torch.float64), 0.25))
        return numbers, learnt

    def _flags(self, inp, acc, tied, ks):
        moved = torch.any(inp.samples[:, 1:, :] != inp.samples[:, :-1, :], dim=2)
        wrong = int((inp.flags[:, 1:] != moved.to(torch.int64)).sum())
        if self.burnin == 0 and acc is not None:
            first = ks == 0
            ok = tied[first] | (inp.flags[:, 0] == acc[first].to(torch.int64))
            wrong += int((~ok).sum())
        return wrong

    def _burnin_rows(self, inp, groups):
        members = torch.cat([group_members(int(g), self.C, self.spec) for g in groups])
        member_groups = torch.cat([torch.full((self.spec["tuning_group"],), i)
                                   for i in range(len(groups))])
        return members.to(inp.theta0s.device), member_groups.to(inp.theta0s.device)

    def _step_gap(self, inp, learnt, control):
        """The tuner's hand-off: the reference's replay of whole groups'
        burn-in against the program's frozen steps."""
        burnin_groups = inp.burnin_groups
        members, local = self._burnin_rows(inp, burnin_groups)
        dtype = torch.bfloat16 if control else torch.float64
        post = self.posterior(inp, dtype)
        theta0 = inp.theta0s[members]
        if self.kind == "hmc":
            ref, n_ref, evals = hmc.tuned_burnin(post.vg, inp.seed, theta0, members, local,
                                                 self.settings, dtype)
            prog = learnt["step"][torch.searchsorted(learnt["groups"],
                                                     burnin_groups.to(learnt["groups"].device))]
            gap = torch.abs(torch.mean(torch.log(prog.double()) - torch.log(ref.double())))
            more = {"burnin_evaluations": evals.double().mean().item(),
                    "n_ref": n_ref.tolist()}
        else:
            ref, work = nuts.tuned_burnin(post.vg, inp.seed, theta0, members, local,
                                          self.settings, dtype)
            # every member's step against its group's
            prog = inp.steps_all[members].double()
            gap = torch.amax(torch.abs(torch.log(prog) - torch.log(ref.double()[local])))
            prog = torch.stack([prog[local == i][0] for i in range(len(burnin_groups))])
            more = {"burnin_work": {k: float(v.mean()) for k, v in work.items()}}
        more.update(step_ref=ref.double().tolist(), step_prog=prog.double().tolist())
        return float(_nan_inf(gap)), more

    def _burnin_end(self, inp, dtype, ulp=False):
        theta0 = inp.theta0s[inp.chains]
        if ulp:  # one float32 ulp away from the benchmark's starts
            theta0 = torch.nextafter(theta0, torch.full_like(theta0, math.inf))
        post = self.posterior(inp, dtype)
        return mala.run(post.vg, inp.seed, theta0, inp.chains, 0, self.burnin + 1,
                        float(self.traffic["args"]["step"]), dtype).double()

    def _burnin_miss(self, inp, dtype):
        """Each sampled chain's distance of the replayed burn-in and first
        kept iteration from its recorded first state."""
        end = self._burnin_end(inp, dtype)
        return _nan_inf(torch.amax(torch.abs(end - inp.samples[:, 0, :]), dim=1))

    def burnin_readings(self, inp):
        """How chaotic the burn-in is: the share of sampled chains whose
        float64 replay lands within ``burnin_tolerance`` of the recorded
        first state, and of the float64 replay from starts one float32 ulp
        away within it of the replay from the starts."""
        tol = self.spec["burnin_tolerance"]
        ref = self._burnin_end(inp, torch.float64)
        moved = self._burnin_end(inp, torch.float64, ulp=True)
        self_miss = _nan_inf(torch.amax(torch.abs(moved - ref), dim=1))
        return {"burnin_followed": float((self._burnin_miss(inp, torch.float64) <= tol)
                                         .double().mean()),
                "burnin_self_ulp_followed": float((self_miss <= tol).double().mean())}


def verdict(numbers, limits):
    """(correct, {name: [value, limit]}): every number at or under its limit."""
    lines = {name: [numbers[name], limits[name]] for name in limits if name in numbers}
    ok = all(value <= limit for value, limit in lines.values()) and \
        set(numbers) >= set(limits) - {"launches"}
    return ok, lines
