"""Multi-process execution: chain sharding, sharded tempering ladders, and
sharded SMC with collective resampling, on torch.distributed.

Counterpart of ``eeyore_tpu/parallel/sharded.py``. Where the JAX package
runs one program over a device mesh (``shard_map``; XLA inserts the
collectives), every rank here calls the entry point itself, on its own
device and its block of the sharded axis (``mesh.chain_sharding``), and the
collectives are explicit ``torch.distributed`` calls on the axis's process
group:

1. ``sample_chains_sharded``, ``run_resident_hmc_sharded`` and
   ``run_resident_tempering_sharded``: independent chains (whole ladders,
   for the tempering kernel), zero collectives.
2. ``run_power_posterior_sharded``: the ladder sharded over the axis;
   within moves are local, and even/odd swap rounds exchange edge rungs
   with the ring neighbours (``batch_isend_irecv``, the ring of JAX's
   ``ppermute``).
3. ``run_smc_sharded``: particles sharded; weight normalisation and ESS by
   all-reduced logsumexps, systematic resampling over the all-gathered
   weights and particles.

Every rank passes the global inputs, as JAX's callers pass global arrays,
and gets back its own block of every chain-axis output, the counterpart of
a process's addressable shards; replicated outputs (the SMC diagnostics)
come back whole on every rank.

Randomness: where JAX splits one key per chain or folds in the device
index, rank ``r`` draws from a generator seeded from
``(generator.initial_seed(), r)`` (``shard_generator``); the power-posterior
ladder's draws come from one generator seeded alike on every rank.

Transport: Gloo moves only CPU tensors, so where the axis's group is Gloo
and a tensor lives on the card the helpers copy it to the host for the
transport and back, explicitly (the compute stays on the card). In a world
of one (no process group) they skip the transport.
"""

import numpy as np
import torch
import torch.distributed as dist

from eeyore_tpu_torch.datasets import as_schedule
from eeyore_tpu_torch.ops.resident_hmc import make_resident_hmc
from eeyore_tpu_torch.ops.resident_hmc_dense import make_resident_hmc_dense
from eeyore_tpu_torch.ops.resident_tempering import make_resident_tempering
from eeyore_tpu_torch.ops.resident_tempering_dense import make_resident_tempering_dense
from eeyore_tpu_torch.parallel.mesh import axis_group, chain_mesh, chain_sharding
from eeyore_tpu_torch.samplers.runner import _generator_or_default, _prepare, _run_generic
from eeyore_tpu_torch.samplers.smc import stack_diagnostics, systematic_resample_indices


def shard_generator(generator, device, *words):
    """A generator on ``device`` seeded from ``generator``'s initial seed
    (the default generator's when None) and ``words`` (a rank), the same on
    every call with the same arguments."""
    seed = _generator_or_default(generator, device).initial_seed()
    state = np.random.SeedSequence([seed, *words]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


# ----------------------------------------------------------------------
# collective helpers
# ----------------------------------------------------------------------

def _world_group(mesh, axis_name):
    """The axis's group, or with no mesh the default group (None without one)."""
    if mesh is not None:
        return axis_group(mesh, axis_name)
    return dist.group.WORLD if dist.is_initialized() else None


def _sharding(mesh, axis_name):
    """This rank's ``ChainSharding`` of ``axis_name`` in ``mesh``, by
    default a ``chain_mesh`` over every rank (as JAX's entry points default
    to one over every device)."""
    return chain_sharding(chain_mesh(axis_name=axis_name) if mesh is None else mesh, axis_name)


def _staged(group, tensor):
    """Whether ``tensor`` crosses a Gloo group from the card (through the host)."""
    return tensor.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _all_reduce(tensor, op, group):
    """``tensor`` reduced by ``op`` over ``group``, through the host on Gloo
    (``tensor`` itself with no group; otherwise reduced in place)."""
    if group is None:
        return tensor
    if _staged(group, tensor):
        host = tensor.cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(tensor.device)
    dist.all_reduce(tensor, op=op, group=group)
    return tensor


def _all_gather(tensor, group):
    """The group's ``tensor``s concatenated in rank order along dim 0,
    through the host on Gloo."""
    if group is None:
        return tensor
    source = tensor.cpu() if _staged(group, tensor) else tensor.contiguous()
    parts = [torch.empty_like(source) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, source, group=group)
    return torch.cat(parts).to(tensor.device)


def _ring_exchange(last_row, first_row, group):
    """(left ghost, right ghost): the left neighbour's ``last_row`` and the
    right neighbour's ``first_row`` on the ring of the group's ranks, as
    ``lax.ppermute`` over (d, d +- 1 mod n) gives them. With one rank, the
    local copy that ppermute to self is; through the host on Gloo."""
    if group is None or dist.get_world_size(group) == 1:
        return last_row.clone(), first_row.clone()
    staged = _staged(group, last_row)
    send_last, send_first = (t.cpu() if staged else t.contiguous() for t in (last_row, first_row))
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    right = dist.get_global_rank(group, (rank + 1) % n)
    left = dist.get_global_rank(group, (rank - 1) % n)
    left_ghost, right_ghost = torch.empty_like(send_last), torch.empty_like(send_first)
    # tags pair the two messages between the same two ranks (n = 2) on Gloo;
    # NCCL matches them by their order, the same on both ranks
    ops = [dist.P2POp(dist.isend, send_last, right, group, tag=0),
           dist.P2POp(dist.isend, send_first, left, group, tag=1),
           dist.P2POp(dist.irecv, left_ghost, left, group, tag=0),
           dist.P2POp(dist.irecv, right_ghost, right, group, tag=1)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return left_ghost.to(last_row.device), right_ghost.to(first_row.device)


def _logsumexp(x, group):
    m = _all_reduce(torch.max(x), dist.ReduceOp.MAX, group)
    s = _all_reduce(torch.sum(torch.exp(x - m)), dist.ReduceOp.SUM, group)
    return torch.log(s) + m


def global_logsumexp(x, axis_name, mesh=None):
    """logsumexp over the local axis and the mesh axis: this rank's ``x``
    and every other rank's of the axis (the default group's when ``mesh``
    is None), the same on every rank."""
    return _logsumexp(x, _world_group(mesh, axis_name))


def _log_ess(log_w, group):
    return 2.0 * _logsumexp(log_w, group) - _logsumexp(2.0 * log_w, group)


def global_log_ess(log_w, axis_name, mesh=None):
    return _log_ess(log_w, _world_group(mesh, axis_name))


# ----------------------------------------------------------------------
# 1. chain-axis data parallelism
# ----------------------------------------------------------------------

def sample_chains_sharded(kernel, generator, theta0s, data, num_iters, num_burnin_iters=0,
                          mesh=None, axis_name="chains", record_keys=None, donate=False):
    """Like ``samplers.sample_chains`` on the generic path, with ``theta0s``
    [C, P] sharded over the mesh's chain axis: this rank runs its block of
    C / ranks chains on its device. Returns the raw recorded arrays {key:
    [C_local, kept, ...]} and the final state of this rank's chains.

    Rank ``r`` draws from ``shard_generator(generator, device, r)``, so its
    block equals ``sample_chains(kernel, that generator, its block, ...,
    backend="scan")`` bit for bit (a one-rank run is ``r`` = 0). Chains are
    independent: no collective. ``donate`` is a JAX buffer setting with no
    torch counterpart."""
    if donate:
        raise ValueError("donate is a JAX buffer setting with no torch counterpart; "
                         "leave it False")
    sharding = _sharding(mesh, axis_name)
    block, schedule = _prepare(kernel, sharding.shard(theta0s), data, num_iters,
                               num_burnin_iters, 1)
    kernel.recompute_current = schedule.num_batches != 1
    kernel.num_burnin_iters = num_burnin_iters
    record_keys = tuple(record_keys or kernel.state_keys)
    state, recorded = _run_generic(kernel, shard_generator(generator, block.device, sharding.rank),
                                   block, schedule, num_iters, num_burnin_iters, record_keys, 1)
    return recorded, state


def _kernel_block(sharding, theta0s, chain_block, what):
    theta0s = torch.as_tensor(theta0s)
    C = theta0s.shape[0]
    if C % (sharding.size * chain_block) != 0:
        raise ValueError(f"{C} {what} must divide over {sharding.size} shards of "
                         f"chain_block {chain_block}")
    return sharding.shard(theta0s)


def run_resident_hmc_sharded(model, x, y, key_seed, theta0s, step, num_steps,
                             num_iters, num_burnin_iters=0, chain_block=2048,
                             mesh=None, axis_name="chains", dense=False):
    """The whole-loop HMC kernel (``ops/resident_hmc.py``, or
    ``ops/resident_hmc_dense.py`` with ``dense=True``) sharded over the
    mesh's chain axis: rank ``r`` builds the maker on its device and makes
    one call, ``fn(key_seed + r * 7919, its block)``, as JAX's shard body
    does (one kernel launch on the card; the plain version on the CPU).
    Zero collectives.

    Returns this rank's (samples [kept, C_local, P], final [C_local, P],
    accept_counts [C_local])."""
    sharding = _sharding(mesh, axis_name)
    block = _kernel_block(sharding, theta0s, chain_block, "chains")
    maker = make_resident_hmc_dense if dense else make_resident_hmc
    fn = maker(model, x, y, step=step, num_steps=num_steps, num_iters=num_iters,
               num_burnin_iters=num_burnin_iters, chain_block=chain_block,
               device=sharding.device)
    return fn(key_seed + sharding.rank * 7919, block)


def run_resident_tempering_sharded(model, x, y, key_seed, theta0s, num_rungs,
                                   step, sampler="MALA", temperatures=None,
                                   between_step=10, num_iters=1000,
                                   num_burnin_iters=0, chain_block=2048,
                                   mesh=None, axis_name="chains", dense=False):
    """The whole-loop parallel-tempering kernel (``ops/resident_tempering.py``,
    or the dense variant with ``dense=True``) sharded over the mesh's chain
    axis. A ladder lives inside one chain block, so sharding the chains
    splits whole ladders: zero collectives. ``theta0s`` is [C, P] with C =
    num_ladders * num_rungs chains, ladder-major; rank ``r`` makes one call
    ``fn(key_seed + r * 7919, its block)``.

    Returns this rank's (samples [kept, C_local, P], final [C_local, P],
    counts [C_local, 2])."""
    sharding = _sharding(mesh, axis_name)
    block = _kernel_block(sharding, theta0s, chain_block, "lanes")
    maker = make_resident_tempering_dense if dense else make_resident_tempering
    fn = maker(model, x, y, num_rungs=num_rungs, step=step, sampler=sampler,
               temperatures=temperatures, between_step=between_step, num_iters=num_iters,
               num_burnin_iters=num_burnin_iters, chain_block=chain_block,
               device=sharding.device)
    return fn(key_seed + sharding.rank * 7919, block)


# ----------------------------------------------------------------------
# 2. sharded power-posterior ladder (even/odd swaps between ring neighbours)
# ----------------------------------------------------------------------

def _swap_round(pp, inner, iteration, x, y, temps, gidx, group, pair_u):
    """One even/odd round over the global ladder on this rank's rungs
    ``gidx`` [L]: the edge rungs come from the ring neighbours, every pair
    tests ``pair_u[min(g, partner)]`` of the N shared uniforms, so both
    members of a pair, on either rank, take the same decision."""
    N, L = pp.num_chains, gidx.shape[0]
    parity = (iteration // pp.between_step) % 2

    def edge(row):
        return torch.cat([inner.sample[row], inner.target_val[row, None]])

    left, right = _ring_exchange(edge(-1), edge(0), group)
    ext_sample = torch.cat([left[None, :-1], inner.sample, right[None, :-1]])
    ext_target = torch.cat([left[-1:], inner.target_val, right[-1:]])
    base_ext, grad_ext = pp._base_val_grad(ext_sample, x, y)
    ext_gidx = torch.cat([gidx[:1] - 1, gidx, gidx[-1:] + 1])
    ext_temps = temps[ext_gidx.clamp(0, N - 1)]

    is_lower = (gidx % 2) == parity
    partner_g = torch.where(is_lower, gidx + 1, gidx - 1)
    valid = (partner_g >= 0) & (partner_g < N)
    lidx = torch.arange(1, L + 1, device=gidx.device)
    pidx = torch.where(is_lower, lidx + 1, lidx - 1)  # the partner's row of ext
    my_temp = ext_temps[lidx]
    log_rate = (-inner.target_val - ext_target[pidx]
                + my_temp * base_ext[pidx] + ext_temps[pidx] * base_ext[lidx])
    u = pair_u[torch.minimum(gidx, partner_g).clamp(0, N - 1)]
    accept = valid & (torch.log(u) < log_rate)

    replacements = {
        "sample": torch.where(accept[:, None], ext_sample[pidx], inner.sample),
        "target_val": torch.where(accept, my_temp * base_ext[pidx], inner.target_val)}
    if pp._has_grad:
        replacements["grad_val"] = torch.where(accept[:, None], my_temp[:, None] * grad_ext[pidx],
                                               inner.grad_val)
    return inner._replace(**replacements)


def run_power_posterior_sharded(pp, generator, theta0, data, num_iters, num_burnin_iters=0,
                                mesh=None, axis_name="temp"):
    """Run an even/odd ``PowerPosteriorSampler`` ladder sharded over
    ``axis_name``: L = num_chains / ranks consecutive rungs a rank. Within
    moves are local; every ``between_step`` iterations an even/odd round
    exchanges the edge rungs' sample and tempered target with the ring
    neighbours and evaluates the untempered target (and gradient) on the L
    + 2 rows.

    Draws, as JAX's code makes them: one generator, seeded from
    ``generator``'s initial seed alike on every rank
    (``shard_generator(generator, device)``), gives each iteration's within
    draws for L rungs, so rung j draws alike on every rank (JAX derives the
    within keys from the replicated key, ``eeyore_tpu/parallel/
    sharded.py:226-227``), and each swap round's N pair uniforms.

    Returns this rank's recorded arrays {key: [L, kept, ...]} for
    ``pp.state_keys``, chain-major; the coldest rung is the last rank's
    last row."""
    sharding = _sharding(mesh, axis_name)
    N = pp.num_chains
    if N % sharding.size != 0:
        raise ValueError(f"num_chains {N} must divide over {sharding.size} shards")
    L = N // sharding.size
    theta0, schedule = _prepare(pp, torch.as_tensor(theta0).to(sharding.device), data,
                                num_iters, num_burnin_iters, 1)
    pp.recompute_current = schedule.num_batches != 1
    if theta0.dim() == 1:
        theta0 = theta0.expand(N, -1)
    like = dict(dtype=theta0.dtype, device=theta0.device)
    temps = pp.temperatures.to(**like)
    rows = sharding.rows(N)
    gidx = torch.arange(rows.start, rows.stop, device=theta0.device)
    kern = pp._make_kernel(temps[rows])
    x0, y0 = schedule.batch(0)
    inner = kern.init(theta0[rows].contiguous(), x0, y0)
    gen = shard_generator(generator, theta0.device)
    record_keys = tuple(pp.state_keys)
    recorded = {k: [] for k in record_keys}
    for i in range(num_iters):
        xb, yb = schedule.batch(i)
        inner = kern.step(inner, xb, yb, generator=gen)[0]
        if i % pp.between_step == 0:
            pair_u = torch.rand(N, generator=gen, **like)
            inner = _swap_round(pp, inner, i, xb, yb, temps, gidx, sharding.group, pair_u)
        if i >= num_burnin_iters:
            for k in record_keys:
                recorded[k].append(getattr(inner, k))
    return {k: torch.stack(v, dim=1) for k, v in recorded.items()}


# ----------------------------------------------------------------------
# 3. sharded SMC
# ----------------------------------------------------------------------

def _smc_stage(smc, particles, log_w, log_z, beta_prev, beta, x, y, sharding, generator=None,
               u=None, noise=None, uniforms=None):
    """One stage on this rank's particles: reweight (the log-evidence
    increment and the ESS over the whole cloud), resample systematically
    over the all-gathered weights and particles and keep this rank's rows,
    then mutate. ``u`` (the resampling uniform), ``noise`` [steps, N_local,
    P] and ``uniforms`` [steps, N_local] are drawn from ``generator``
    unless given. Returns (particles, log_w, log_z, diagnostics)."""
    group = sharding.group
    n = particles.shape[0] * sharding.size
    pots = smc._potential(particles, x, y)
    incr = (beta - beta_prev) * pots
    log_norm_prev = log_w - _logsumexp(log_w, group)
    log_z = log_z + _logsumexp(log_norm_prev + incr, group)
    log_w = log_w + incr
    ess = torch.exp(_log_ess(log_w, group))
    do_resample = ess < smc.ess_threshold * n

    all_log_w = _all_gather(log_w, group)            # [N]
    all_particles = _all_gather(particles, group)    # [N, P]
    idx = systematic_resample_indices(generator, torch.softmax(all_log_w, 0), u=u)
    mine = idx[sharding.rows(n)]
    particles = torch.where(do_resample, all_particles[mine], particles)
    log_w = torch.where(do_resample, torch.zeros_like(log_w), log_w)

    particles, acc = smc._mutate(generator, particles, beta, x, y, noise=noise,
                                 uniforms=uniforms)
    acceptance = _all_reduce(torch.mean(acc), dist.ReduceOp.SUM, group) / sharding.size
    return particles, log_w, log_z, {"ess": ess, "resampled": do_resample,
                                     "mutation_acceptance": acceptance}


def run_smc_sharded(smc, generator, data, mesh=None, axis_name="particles"):
    """Run an ``SMCSampler`` over its fixed schedule with the particle axis
    sharded over the mesh: N / ranks particles a rank, born on the rank
    (the prior, or ``init_sampler``), all-reduced weight normalisation and
    ESS, systematic resampling over the gathered global weights (one
    scalar a particle) and particle rows, and the mutation on the rank.

    Rank ``r`` draws from ``shard_generator(generator, device, r)``, its
    resampling uniform included: the global resample is stratified by rank,
    as JAX's code draws it from a per-device key
    (``eeyore_tpu/parallel/sharded.py:352-366``), and still unbiased.

    Returns this rank's (particles [N_local, P], log_weights [N_local]) and
    the diagnostics, the same on every rank: per-stage "ess",
    "resampled", "mutation_acceptance" (CPU tensors) and "log_evidence"."""
    if smc.betas is None:
        raise ValueError("run_smc_sharded runs a fixed schedule; adaptive betas have no "
                         "sharded runner")
    sharding = _sharding(mesh, axis_name)
    N = smc.num_particles
    if N % sharding.size != 0:
        raise ValueError(f"num_particles {N} must divide over {sharding.size} shards")
    n_local = N // sharding.size
    schedule = as_schedule(data).to(device=sharding.device,
                                    dtype=getattr(smc.model, "dtype", None))
    x, y = schedule.batch(0)
    gen = shard_generator(generator, sharding.device, sharding.rank)
    if smc._is_bayesian:
        particles = smc.model.prior.sample(gen, (n_local,))
    else:
        particles = torch.as_tensor(smc.init_sampler(gen, n_local))
    like = dict(dtype=particles.dtype, device=particles.device)
    log_w = torch.zeros(n_local, **like)
    log_z = torch.zeros((), **like)
    betas = smc.betas.to(**like)
    outs = []
    for k in range(1, len(betas)):
        particles, log_w, log_z, out = _smc_stage(smc, particles, log_w, log_z, betas[k - 1],
                                                  betas[k], x, y, sharding, generator=gen)
        outs.append(out)
    diagnostics = stack_diagnostics(outs)
    diagnostics["log_evidence"] = float(log_z)
    return particles, log_w, diagnostics
