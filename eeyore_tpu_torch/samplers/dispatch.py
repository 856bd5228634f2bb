"""Kernel-backend dispatch: route ``sample_chains`` onto the whole-loop
kernels when the configuration is eligible.

Counterpart of the HMC, NUTS, MH, MALA and Gibbs parts of
``eeyore_tpu/samplers/dispatch.py``. ``resolve_backend`` decides, per
(transition kernel, model, data, chain count), which engine runs the
request, and ``run_kernel_backend`` runs it and re-wraps the kernel's
outputs in the stacked-tensor contract of the generic path.

Backends:
- ``"dense"``: the kernels with the data folded in as constants
  (``ops/resident_hmc_dense.py``, ``ops/resident_walk_dense.py``). Needs at
  most ``MAX_DENSE_ROWS`` data rows and a chain count divisible by 1024.
- ``"resident"``: the kernels on staged data (``ops/resident_hmc.py``,
  ``ops/resident_walk.py``), for any number of rows. Needs a chain count
  divisible by 128.
- ``"scan"``: the generic path; always eligible.
- ``"auto"``: dense if eligible, else resident, else scan.

Both kernel backends need the model and the data on a CUDA device, a
full-batch schedule, an ``extract_arch``-able MLP and at most
``MAX_DISPATCH_PARAMS`` parameters. HMC, fixed-budget NUTS (``fixed_budget=True``
or a resolved ``max_depth="auto"``, at most ``MAX_KERNEL_DEPTH``; its
kernels ``ops/resident_nuts{,_dense}.py``), random-walk MH (a symmetric
``NormalKernel`` of scalar scale), MALA and blocked Gibbs have kernels;
every other sampler (adaptive NUTS, an asymmetric or vector-scale MH) runs
the generic path under ``"auto"``.

Statistical contract: the kernel draws its own numbers (``ops/
kernel_prng.py``) from a seed taken from the caller's generator, so its runs
are statistically equivalent to, not equal to, the generic path's. Recorded
keys by default are ``sample`` plus a derived ``accepted`` flag (sample[t]
!= sample[t-1], with the first kept row set from the kernel's accept count,
or to 1 where the count is per Gibbs sub-block, ``info["accept_counts"]``
[C, B], or NUTS's sum of accept_stat, where ``info["divergent_sums"]`` [C]
holds the divergences too);
an explicit ``record_keys`` containing ``target_val`` turns on the kernel's
extras rows, which carry the value and an exact moved flag. Any other key
forces the generic path.

``resolve_tempering`` and ``run_tempering_backend`` do the same for
``PowerPosteriorSampler.run``: an even/odd ladder with MALA or MH within
the rungs runs on the tempering move of the walk kernels, a block of
whole ladders in one launch. ``resolve_smc`` and ``run_smc_backend`` send
``SMCSampler.run`` to the SMC runner of ``ops/resident_smc.py``: one launch
of the mutation kernel per stage, its closure kernel for a
``DistributionModel`` target.
"""

import inspect

import numpy as np
import torch

from eeyore_tpu_torch.datasets import as_schedule
from eeyore_tpu_torch.ops.mlp_dense import MAX_DENSE_ROWS

BACKENDS = ("auto", "scan", "resident", "dense")

# keys the kernel backend can record; an explicit request for anything else
# forces the generic path
KERNEL_RECORD_KEYS = frozenset({"sample", "accepted", "target_val"})

_DENSE_BLOCKS = (8192, 4096, 2048, 1024)
_RESIDENT_BLOCKS = (4096, 2048, 1024, 512, 256, 128)
MAX_DISPATCH_PARAMS = 256
# JAX's streamed-body block caps of the staged HMC and NUTS kernels: 256 on
# data of at least SMALL_MODEL_ROWS rows, else 4096; on the card a tuned
# group is also capped by what the build of its lanes holds (_hmc_group_cap,
# _nuts_group_cap).
SMALL_MODEL_ROWS = 32
KERNEL_MAX_NUM_STEPS = 64
# JAX's limit on the NUTS kernels' depth, from its TPU compile service (its
# kernels unroll the 2^depth - 1 leapfrogs). The CUDA kernels loop over the
# leaves and have no such limit; the port keeps JAX's so that it routes where
# JAX routes.
MAX_KERNEL_DEPTH = 5


def _freeze(v):
    """Hashable fingerprint of a maker argument, by value: arrays by their
    bytes, config objects (tuners) by their type and scalar attributes, so
    two equal configurations share a cache entry."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return ("ndarray", v.shape, str(v.dtype), v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return (type(v).__name__, tuple(sorted(
        (k, _freeze(x)) for k, x in vars(v).items()
        if isinstance(x, (bool, int, float, str, type(None))))))


def _data_fingerprint(x, y):
    return (x.shape, str(x.dtype), hash(x.tobytes()),
            y.shape, str(y.dtype), hash(y.tobytes()))


def _model_fingerprint(model):
    """What a maker bakes in from the model besides its architecture: the
    temperature and the prior's loc and scale, by value; for a model
    without a prior (a ``DistributionModel``), its log-pdf closure."""
    prior = getattr(model, "prior", None)
    if prior is None:
        return (_freeze(model.temperature), id(model.log_pdf))
    return (_freeze(model.temperature), _freeze(prior.loc), _freeze(prior.scale))


class _Plan:
    """``acc_kind``: "counts" when the kernel returns accepted-transition
    counts [C], "per_block" when it returns them per Gibbs sub-block [C, B]
    (a tempering plan's counts [C, 2] go to the walk module's
    ``last_info``), "stat" for NUTS's sums of accept_stat [C], followed by
    its divergence sums [C]."""

    def __init__(self, backend, maker, kwargs, chain_block, acc_kind="counts"):
        self.backend = backend
        self.maker = maker
        self.kwargs = kwargs
        self.chain_block = chain_block
        self.acc_kind = acc_kind


def _pick_block(num_chains, candidates, cap=None):
    for cb in candidates:
        if cap is not None and cb > cap:
            continue
        if num_chains % cb == 0:
            return cb
    return None


def _cap_note(cap):
    """What a reason adds where the card caps the tuning group (``cap`` from
    ``_largest_group``; None off the card or untuned)."""
    if cap is None:
        return ""
    if cap == 0:
        return " (this card holds no tuning group of this build)"
    return f" (tuning groups of at most {cap} on this card)"


def _largest_group(blocks, group_shape):
    """The largest of ``blocks`` for which ``group_shape(cb)`` finds a launch
    shape (it raises ValueError where the card cannot hold the group), else
    0."""
    for cb in blocks:
        try:
            group_shape(cb)
        except ValueError:
            continue
        return cb
    return 0


def _dense_group_cap(kernel, x, y):
    """The largest dense block that a tuned population run's tuning group can
    be on this card: a group is one thread-block cluster, and what the
    build's registers and the card allow is asked of the CUDA runtime
    (``resident_hmc_dense.group_shape``). No cap off the card, where the
    plain version runs."""
    if not x.is_cuda:
        return None
    from eeyore_tpu_torch.ops import resident_hmc_dense

    lib = resident_hmc_dense.load_kernel(kernel.model, x.cpu().numpy(), y.cpu().numpy())
    return _largest_group(_DENSE_BLOCKS, lambda cb: resident_hmc_dense.group_shape(lib, cb))


def _jax_resident_cap(x):
    """JAX's cap on the staged HMC and NUTS kernels' chain_block."""
    return 256 if x.shape[0] >= SMALL_MODEL_ROWS else 4096


def _hmc_group_cap(kernel, x, y, blocks):
    """The largest of ``blocks`` that a tuned staged HMC run's tuning group
    can be on this card: the build of its lanes a chain
    (``resident_hmc.chain_lanes``) is asked, as ``_nuts_group_cap`` asks the
    NUTS builds; None untuned or off the card."""
    if kernel.tuner is None or not x.is_cuda:
        return None
    from eeyore_tpu_torch.ops import resident_hmc
    from eeyore_tpu_torch.ops.mlp_math import prepare_data

    n_rows = prepare_data(kernel.model, x.cpu().numpy(), y.cpu().numpy())[0].shape[0]

    def group_shape(cb):
        lib = resident_hmc.load_kernel(kernel.model, resident_hmc.chain_lanes(n_rows, cb, True))
        return resident_hmc.launch_threads(lib, cb, n_rows, True)

    return _largest_group(blocks, group_shape)


def _nuts_group_cap(kernel, x, y, dense, inv_mass, blocks):
    """The largest of ``blocks`` that a tuned NUTS run's tuning group can be
    on this card (the NUTS kernel's build asked, as ``_dense_group_cap`` asks
    the dense HMC one; a staged group takes the build of its lanes a chain,
    ``resident_nuts.chain_lanes``); None untuned or off the card."""
    if kernel.tuner is None or not x.is_cuda:
        return None
    from eeyore_tpu_torch.ops import resident_nuts, resident_nuts_dense
    from eeyore_tpu_torch.ops.mlp_math import prepare_data

    xn, yn = x.cpu().numpy(), y.cpu().numpy()
    if dense:
        lib = resident_nuts_dense.load_kernel(kernel.model, xn, yn, kernel.max_depth, inv_mass)
        return _largest_group(blocks, lambda cb: resident_nuts_dense.group_shape(lib, cb))
    n_rows = prepare_data(kernel.model, xn, yn)[0].shape[0]

    def group_shape(cb):
        lib = resident_nuts.load_kernel(kernel.model, kernel.max_depth,
                                        resident_nuts.chain_lanes(cb, True))
        return resident_nuts.group_shape(lib, cb, n_rows)

    return _largest_group(blocks, group_shape)


def _nuts_plan(kernel, x, y, num_chains, common, want_dense):
    """The NUTS branch of ``_sampler_plan`` (JAX's, reasons included)."""
    # max_depth="auto" kernels dispatch as fixed-budget once the probe has
    # resolved their depth (the fixed-budget and adaptive trees draw the same
    # samples at equal max_depth, so the probed depth cap is the only change)
    auto_ok = kernel.auto_depth and kernel._auto_fingerprint is not None
    if not kernel.fixed_budget and not auto_ok:
        return None, ("adaptive NUTS has data-dependent trees; only fixed_budget=True (or "
                      "max_depth='auto') dispatches to the kernels")
    if int(kernel.max_depth) > MAX_KERNEL_DEPTH:
        return None, (f"max_depth={kernel.max_depth} > MAX_KERNEL_DEPTH={MAX_KERNEL_DEPTH} "
                      "(the kernels unroll 2^depth-1 leapfrogs; deep budgets run the scanned "
                      "engine)")
    frozen_metric = kernel._frozen_inv_mass
    if kernel.mass_adapt and frozen_metric is None:
        return None, ("mass_adapt needs a FROZEN metric for the kernels: use max_depth='auto' "
                      "(the warmup probe freezes the diagonal) or the scanned path")
    nuts_kw = dict(step=float(kernel.step0), max_depth=kernel.max_depth, tuner=kernel.tuner,
                   **common)
    if frozen_metric is not None:
        nuts_kw["inv_mass"] = np.asarray(frozen_metric)
    # the staged kernel: JAX's streamed-body cap, and on the card what a
    # tuning group can be
    jax_cap = _jax_resident_cap(x)
    blocks = _DENSE_BLOCKS if want_dense else tuple(b for b in _RESIDENT_BLOCKS if b <= jax_cap)
    cap = _nuts_group_cap(kernel, x, y, want_dense, nuts_kw.get("inv_mass"), blocks)
    if want_dense:
        from eeyore_tpu_torch.ops.resident_nuts_dense import make_resident_nuts_dense

        cb = _pick_block(num_chains, _DENSE_BLOCKS, cap=cap)
        if cb is None:
            return None, "dense NUTS needs chains divisible by 1024" + _cap_note(cap)
        return _Plan("dense", make_resident_nuts_dense, dict(chain_block=cb, **nuts_kw), cb,
                     acc_kind="stat"), None
    from eeyore_tpu_torch.ops.resident_nuts import make_resident_nuts

    cb = _pick_block(num_chains, _RESIDENT_BLOCKS,
                     cap=jax_cap if cap is None else min(cap, jax_cap))
    if cb is None:
        return None, ("resident NUTS needs chains divisible by 128"
                      + _cap_note(cap if cap is not None and cap < jax_cap else None))
    return _Plan("resident", make_resident_nuts, dict(chain_block=cb, **nuts_kw), cb,
                 acc_kind="stat"), None


def _sampler_plan(kernel, x, y, num_chains, num_iters, num_burnin_iters, record_thin,
                  want_dense, record_extras=False):
    """Return a _Plan for the transition kernel, or (None, reason)."""
    from eeyore_tpu_torch.kernels import NormalKernel
    from eeyore_tpu_torch.samplers.gibbs import Gibbs
    from eeyore_tpu_torch.samplers.hmc import HMC
    from eeyore_tpu_torch.samplers.mala import MALA
    from eeyore_tpu_torch.samplers.mh import MetropolisHastings
    from eeyore_tpu_torch.samplers.nuts import NUTS

    common = dict(num_iters=num_iters, num_burnin_iters=num_burnin_iters,
                  record_thin=record_thin, record_extras=record_extras)

    if type(kernel) is MetropolisHastings:
        if not kernel.symmetric or not isinstance(kernel.kernel, NormalKernel):
            return None, "kernel backends support symmetric Normal-proposal MH only"
        if kernel.kernel.scale.dim() != 0:
            return None, "kernel backends need a scalar MH proposal scale"
        scale = float(kernel.kernel.scale)
        if want_dense:
            from eeyore_tpu_torch.ops.resident_walk_dense import make_resident_mh_dense
            cb = _pick_block(num_chains, _DENSE_BLOCKS)
            if cb is None:
                return None, "dense MH needs chains divisible by 1024"
            return _Plan("dense", make_resident_mh_dense,
                         dict(scale=scale, chain_block=cb, **common), cb), None
        from eeyore_tpu_torch.ops.resident_walk import make_resident_mh
        cb = _pick_block(num_chains, _RESIDENT_BLOCKS)
        if cb is None:
            return None, "resident MH needs chains divisible by 128"
        return _Plan("resident", make_resident_mh,
                     dict(scale=scale, chain_block=cb, **common), cb), None

    if type(kernel) is MALA:
        step = float(kernel.step_size)
        if want_dense:
            from eeyore_tpu_torch.ops.resident_walk_dense import make_resident_mala_dense
            cb = _pick_block(num_chains, _DENSE_BLOCKS)
            if cb is None:
                return None, "dense MALA needs chains divisible by 1024"
            return _Plan("dense", make_resident_mala_dense,
                         dict(step=step, chain_block=cb, **common), cb), None
        from eeyore_tpu_torch.ops.resident_walk import make_resident_mala
        cb = _pick_block(num_chains, _RESIDENT_BLOCKS, cap=4096)
        if cb is None:
            return None, "resident MALA needs chains divisible by 128"
        return _Plan("resident", make_resident_mala,
                     dict(step=step, chain_block=cb, **common), cb), None

    if type(kernel) is NUTS:
        return _nuts_plan(kernel, x, y, num_chains, common, want_dense)

    if type(kernel) is Gibbs:
        gibbs_kw = dict(scales=list(kernel.scales),
                        node_subblock_size=list(kernel.node_subblock_size), **common)
        if want_dense:
            from eeyore_tpu_torch.ops.resident_walk_dense import make_resident_gibbs_dense
            cb = _pick_block(num_chains, _DENSE_BLOCKS)
            if cb is None:
                return None, "dense Gibbs needs chains divisible by 1024"
            return _Plan("dense", make_resident_gibbs_dense, dict(chain_block=cb, **gibbs_kw),
                         cb, acc_kind="per_block"), None
        from eeyore_tpu_torch.ops.resident_walk import make_resident_gibbs
        # No cap of 512 as JAX's (its VMEM activation cache of 8 [n_pad,
        # chain_block] tiles): the Gibbs moves share nothing between chains
        # and have no tuner, so chain_block only has to divide the chains,
        # and the block is capped by the move's registers (WALK_BLOCK, or
        # fewer threads when the build allows fewer), as for MH and MALA.
        cb = _pick_block(num_chains, _RESIDENT_BLOCKS)
        if cb is None:
            return None, "resident Gibbs needs chains divisible by 128"
        return _Plan("resident", make_resident_gibbs, dict(chain_block=cb, **gibbs_kw), cb,
                     acc_kind="per_block"), None

    if type(kernel) is not HMC:
        return None, f"{type(kernel).__name__} has no kernel backend yet"
    hmc_kw = dict(step=float(kernel.step0), num_steps=int(kernel.num_steps0),
                  tuner=kernel.tuner, **common)
    if kernel.tuner is not None:
        # the kernel caps the trajectory: shortening a user-configured
        # ceiling would change the sampler, so an explicit one above the cap
        # is ineligible; the default ceiling takes the kernel's cap
        if kernel.explicit_max_num_steps:
            if int(kernel.max_num_steps) > KERNEL_MAX_NUM_STEPS:
                return None, (f"max_num_steps={kernel.max_num_steps} > the kernel cap "
                              f"{KERNEL_MAX_NUM_STEPS}; use the generic path or lower "
                              "max_num_steps")
            hmc_kw["max_num_steps"] = int(kernel.max_num_steps)
        else:
            hmc_kw["max_num_steps"] = min(int(kernel.max_num_steps), KERNEL_MAX_NUM_STEPS)
        hmc_kw["l_rounding"] = kernel.l_rounding
    if want_dense:
        from eeyore_tpu_torch.ops.resident_hmc_dense import make_resident_hmc_dense
        cap = _dense_group_cap(kernel, x, y) if kernel.tuner is not None else None
        cb = _pick_block(num_chains, _DENSE_BLOCKS, cap=cap)
        if cb is None:
            return None, "dense HMC needs chains divisible by 1024" + _cap_note(cap)
        return _Plan("dense", make_resident_hmc_dense, dict(chain_block=cb, **hmc_kw),
                     cb), None
    from eeyore_tpu_torch.ops.resident_hmc import make_resident_hmc

    # JAX's cap, and on the card what a tuning group can be
    jax_cap = _jax_resident_cap(x)
    cap = _hmc_group_cap(kernel, x, y, tuple(b for b in _RESIDENT_BLOCKS if b <= jax_cap))
    cb = _pick_block(num_chains, _RESIDENT_BLOCKS,
                     cap=jax_cap if cap is None else min(cap, jax_cap))
    if cb is None:
        return None, ("resident HMC needs chains divisible by 128"
                      + _cap_note(cap if cap is not None and cap < jax_cap else None))
    return _Plan("resident", make_resident_hmc, dict(chain_block=cb, **hmc_kw), cb), None


def _platform(kernel, schedule):
    """"cuda" when the model and the data live on a CUDA device."""
    model_device = getattr(kernel.model, "device", None)
    on_cuda = schedule.x.is_cuda and (model_device is None
                                      or torch.device(model_device).type == "cuda")
    return "cuda" if on_cuda else schedule.x.device.type


def resolve_backend(kernel, data, num_chains, num_iters, num_burnin_iters=0, record_thin=1,
                    backend="auto", platform=None, record_keys=None):
    """Decide which engine runs this request.

    Returns ``(plan_or_None, reason)``: a :class:`_Plan` when the kernel
    backend will run, else ``(None, why_generic)``. Explicit "resident" and
    "dense" raise when ineligible instead of falling back. ``platform``
    ("cuda" or "cpu") defaults to where the model and data live.
    ``record_keys``: the caller's explicit record request (None = the
    sampler's default); a key the kernel cannot record is an ineligibility.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "scan":
        return None, "explicit backend='scan'"

    def fail(reason):
        if backend in ("resident", "dense"):
            raise ValueError(f"backend={backend!r} requested but ineligible: {reason}")
        return None, reason

    record_extras = False
    if record_keys is not None:
        extra = set(record_keys) - KERNEL_RECORD_KEYS
        if extra:
            return fail(f"record_keys {sorted(extra)} not recordable by the kernel backend "
                        f"(it records {sorted(KERNEL_RECORD_KEYS)} only)")
        record_extras = "target_val" in record_keys

    schedule = as_schedule(data)
    platform = platform or _platform(kernel, schedule)
    if platform != "cuda":
        return fail(f"the kernel backend needs the model and data on a CUDA device "
                    f"(they are on {platform})")
    if schedule.num_batches != 1:
        return fail("the kernel backend runs full-batch only")
    x, y = schedule.x[0], schedule.y[0]
    model = kernel.model
    try:
        from eeyore_tpu_torch.ops.mlp_math import extract_arch
        extract_arch(model)
    except (ValueError, AttributeError) as err:
        return fail(f"model not kernel-compatible: {err}")
    if model.num_params > MAX_DISPATCH_PARAMS:
        return fail(f"{model.num_params} params > MAX_DISPATCH_PARAMS={MAX_DISPATCH_PARAMS} "
                    "(one thread carries a chain's state in registers)")

    dense_ok = x.shape[0] <= MAX_DENSE_ROWS
    if backend == "dense":
        order = [True]
    elif backend == "resident":
        order = [False]
    else:  # auto: dense first when the data fits, then resident
        order = [True, False] if dense_ok else [False]
    reason = None
    for want_dense in order:
        if want_dense and not dense_ok:
            reason = f"{x.shape[0]} data rows > MAX_DENSE_ROWS={MAX_DENSE_ROWS}"
            continue
        plan, reason = _sampler_plan(kernel, x, y, num_chains, num_iters, num_burnin_iters,
                                     record_thin, want_dense, record_extras=record_extras)
        if plan is not None:
            return plan, None
    return fail(reason)


def run_kernel_backend(kernel, generator, theta0s, data, num_iters, num_burnin_iters, plan,
                       record_thin=1, needs_accepted=True):
    """Execute a resolved plan; returns ``(recorded, info)`` where
    ``recorded`` matches ``sample_chains(..., return_arrays=True)``'s
    stacked tensors ({"sample": [C, kept, P], "accepted": [C, kept], and
    "target_val" [C, kept] with extras}) and ``info`` carries the kernel's
    exact per-chain accept counts and the final states. The kernel's seed is
    drawn from ``generator``.

    ``needs_accepted=False`` skips the derived accepted flags (a pass over
    the samples)."""
    schedule = as_schedule(data)
    x, y = schedule.x[0].cpu().numpy(), schedule.y[0].cpu().numpy()
    theta0s = torch.as_tensor(theta0s)

    cache = getattr(kernel, "_backend_cache", None)
    if cache is None:
        cache = kernel._backend_cache = {}
    # the maker copies the data, the prior and the temperature to the device:
    # key on their values
    cache_key = (plan.maker.__name__, str(theta0s.device), plan.chain_block,
                 _data_fingerprint(x, y), _model_fingerprint(kernel.model),
                 _freeze(plan.kwargs))
    if cache_key not in cache:
        cache[cache_key] = plan.maker(kernel.model, x, y, device=theta0s.device,
                                      **plan.kwargs)
    fn = cache[cache_key]
    want_extras = bool(plan.kwargs.get("record_extras", False))
    # dispatch hands over chain-major [C, P] inits: say so to the dense HMC
    # function, which would otherwise read the layout from the shape
    call_kw = ({"dense_input": False} if "dense_input" in inspect.signature(fn).parameters
               else {})

    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device if generator is not None else "cpu"))
    out = fn(seed, theta0s, **call_kw)
    if want_extras:
        out, values, flags = out[:-2], out[-2], out[-1]
    # [kept, C, P] view of the kernel's [kept, P, C] -> [C, kept, P], one copy
    samples = out[0].transpose(0, 1).contiguous()
    final, acc = out[1], out[2]
    recorded = {"sample": samples}
    if want_extras:
        recorded["accepted"] = flags.T.contiguous()
        recorded["target_val"] = values.T.contiguous()
    elif needs_accepted:
        # derived accepted: moved against the previous kept row; where the
        # kernel returns accepted-transition counts (record_thin 1) the first
        # kept row takes the count's remainder, else (per-sub-block Gibbs
        # counts, NUTS's accept_stat sums) it is 1, as in the JAX package
        moved = torch.any(samples[:, 1:, :] != samples[:, :-1, :], dim=-1)
        if plan.acc_kind == "counts" and record_thin == 1:
            first = torch.clamp(torch.round(acc - moved.sum(dim=1)), 0, 1)
        else:
            first = torch.ones(moved.shape[0], dtype=acc.dtype, device=acc.device)
        recorded["accepted"] = torch.cat([first[:, None].to(moved.dtype), moved],
                                         dim=1).to(torch.int32)
    kept = (num_iters - num_burnin_iters) // record_thin
    info = {"accept_counts": acc, "final": final, "kept": kept, "backend": plan.backend}
    if plan.acc_kind == "stat":
        info["divergent_sums"] = out[3]
    del out
    return recorded, info


# ----------------------------------------------------------------------
# Tempering-ladder dispatch (PowerPosteriorSampler.run -> tempering kernels)
# ----------------------------------------------------------------------

def resolve_tempering(pp, data, num_iters, num_burnin_iters=0, record_thin=1, backend="auto",
                      platform=None, record_keys=None):
    """Dispatch decision for a power-posterior ladder run: the tempering
    kernels (``ops/resident_tempering{,_dense}.py``) run even/odd-swap
    parallel tempering with MALA or MH within the rungs, the reference's
    ladder sampler pair (power_posterior_sampler.py:68-82). Categorical
    swaps (the reference's default scheme) stay on the generic path: their
    serial single-pair draws do not vectorize into adjacent exchanges.

    Returns ``(plan_or_None, reason)``; explicit "resident" and "dense"
    raise when ineligible. The plan runs the smallest dense block, else
    resident block, that holds whole ladders."""
    from eeyore_tpu_torch.ops.resident_walk import WALK_BLOCK
    from eeyore_tpu_torch.ops.resident_walk_dense import SUBLANES

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "scan":
        return None, "explicit backend='scan'"

    def fail(reason):
        if backend in ("resident", "dense"):
            raise ValueError(f"backend={backend!r} requested but ineligible: {reason}")
        return None, reason

    record_extras = False
    if record_keys is not None:
        extra = set(record_keys) - KERNEL_RECORD_KEYS
        if extra:
            return fail(f"record_keys {sorted(extra)} not recordable by the tempering kernels")
        record_extras = "target_val" in record_keys

    schedule = as_schedule(data)
    platform = platform or _platform(pp, schedule)
    if platform != "cuda":
        return fail(f"the kernel backend needs the model and data on a CUDA device "
                    f"(they are on {platform})")
    if schedule.num_batches != 1:
        return fail("the kernel backend runs full-batch only")
    if pp.swap_scheme != "even_odd":
        return fail("the tempering kernels implement even/odd swaps; categorical stays generic")
    if pp.sampler not in ("MALA", "MetropolisHastings"):
        return fail(f"ladder sampler {pp.sampler!r} has no kernel")
    extra = set(pp.sampler_kwargs) - {"step", "scale"}
    if extra:
        return fail(f"sampler_kwargs {sorted(extra)} not kernel-mappable")
    x = schedule.x[0]
    model = pp.model
    try:
        from eeyore_tpu_torch.ops.mlp_math import extract_arch
        extract_arch(model)
    except (ValueError, AttributeError) as err:
        return fail(f"model not kernel-compatible: {err}")
    if model.num_params > MAX_DISPATCH_PARAMS:
        return fail(f"{model.num_params} params > MAX_DISPATCH_PARAMS={MAX_DISPATCH_PARAMS}")

    L = int(pp.num_chains)
    # a ladder swaps through the shared memory of one CUDA block, and every
    # build of the walk kernels holds a block of WALK_BLOCK threads (the JAX
    # package takes ladders as long as its blocks, up to 8192 chains)
    if L > WALK_BLOCK:
        return fail(f"a ladder of {L} rungs does not fit one CUDA block "
                    f"(at most resident_walk.WALK_BLOCK={WALK_BLOCK} rungs)")
    # the defaults of the generic path's inner samplers: MALA(step=0.1),
    # MetropolisHastings -> NormalKernel(scale=1.0)
    if pp.sampler == "MALA":
        step = float(pp.sampler_kwargs.get("step", 0.1))
    else:
        step = float(pp.sampler_kwargs.get("scale", 1.0))
    kw = dict(num_rungs=L, step=step, sampler=pp.sampler,
              temperatures=pp.temperatures.cpu().numpy(), between_step=pp.between_step,
              num_iters=num_iters, num_burnin_iters=num_burnin_iters, record_thin=record_thin,
              record_extras=record_extras)

    if backend == "dense" and x.shape[0] > MAX_DENSE_ROWS:
        return fail(f"{x.shape[0]} data rows > MAX_DENSE_ROWS={MAX_DENSE_ROWS}")
    if x.shape[0] <= MAX_DENSE_ROWS and backend in ("auto", "dense"):
        # the dense layout lays ladders along the chain_block / 8 lanes
        for cb in sorted(_DENSE_BLOCKS):
            if (cb // SUBLANES) % L == 0:
                from eeyore_tpu_torch.ops.resident_tempering_dense import (
                    make_resident_tempering_dense,
                )
                return _Plan("dense", make_resident_tempering_dense, dict(chain_block=cb, **kw),
                             cb), None
    if backend in ("auto", "resident"):
        for cb in sorted(_RESIDENT_BLOCKS):
            if cb % L == 0:
                from eeyore_tpu_torch.ops.resident_tempering import make_resident_tempering
                return _Plan("resident", make_resident_tempering, dict(chain_block=cb, **kw),
                             cb), None
    return fail(f"no kernel block divisible by the {L}-rung ladder")


def run_tempering_backend(pp, generator, theta0, data, num_iters, num_burnin_iters, plan,
                          record_thin=1, all_ladders=False):
    """Execute a resolved tempering plan for one ladder: the kernel runs
    ``chain_block`` chains (chain_block / L ladders, which part through
    their draws) and ladder 0's rungs come back, the coldest last, as
    ``PowerPosteriorSampler.run`` lays them out. The kernel's seed is drawn
    from ``generator``; ``theta0`` is [P] (every chain) or [L, P] (each
    rung, tiled over the ladders).

    ``all_ladders=True`` keeps every ladder the block computed: the
    ``ChainLists`` holds ``chain_block`` chains ladder-major (ladder g's
    rungs at chains [g L, (g + 1) L)), so cross-ladder diagnostics need no
    extra runs.

    Recorded keys: ``sample``, ``accepted`` (the kernel's moved flags with
    extras; else derived, sample[t] != sample[t-1], with the first row 1)
    and, with extras, ``target_val``, the tempered value (the kernel's
    untempered value times the rung's temperature). The kernel's counts [C,
    2] (within-rung and swap accepts) stay in the walk module's
    ``last_info``."""
    from eeyore_tpu_torch.chains import ChainLists

    schedule = as_schedule(data)
    x, y = schedule.x[0].cpu().numpy(), schedule.y[0].cpu().numpy()
    theta0 = torch.as_tensor(theta0)
    L = int(pp.num_chains)
    cb = plan.chain_block
    keep = cb if all_ladders else L

    cache = getattr(pp, "_backend_cache", None)
    if cache is None:
        cache = pp._backend_cache = {}
    cache_key = (plan.maker.__name__, str(theta0.device), cb, _data_fingerprint(x, y),
                 _model_fingerprint(pp.model), _freeze(plan.kwargs))
    if cache_key not in cache:
        cache[cache_key] = plan.maker(pp.model, x, y, device=theta0.device, **plan.kwargs)
    fn = cache[cache_key]

    theta0 = theta0.to(torch.float32)
    if theta0.dim() != 1 and theta0.shape[0] != L:
        raise ValueError(f"theta0 must be [P] or [{L}, P] (one per rung), got "
                         f"{tuple(theta0.shape)}")
    if theta0.dim() == 1:
        theta0s = theta0.expand(cb, -1).contiguous()
    else:  # [L, P] per-rung inits, tiled across the block's ladders
        theta0s = theta0.repeat(cb // L, 1)
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device if generator is not None else "cpu"))
    out = fn(seed, theta0s)
    ladders = out[0][:, :keep].transpose(0, 1).contiguous()  # [keep, kept, P]
    arrays = {"sample": ladders}
    if plan.kwargs.get("record_extras", False):
        temps = pp.temperatures.to(dtype=torch.float32, device=ladders.device).repeat(keep // L)
        arrays["accepted"] = out[4][:, :keep].T.contiguous()
        arrays["target_val"] = out[3][:, :keep].T * temps[:, None]
    else:
        moved = torch.any(ladders[:, 1:] != ladders[:, :-1], dim=-1)
        first = torch.ones((keep, 1), dtype=moved.dtype, device=moved.device)
        arrays["accepted"] = torch.cat([first, moved], dim=1).to(torch.int32)
    return ChainLists.from_arrays(arrays)


# ----------------------------------------------------------------------
# SMC dispatch (SMCSampler.run -> the SMC runner on the mutation kernel)
# ----------------------------------------------------------------------

def resolve_smc(smc, data, backend="auto", platform=None):
    """Dispatch decision for a tempered-SMC run: the runner of
    ``ops/resident_smc.py::make_resident_smc`` reweights, resamples and
    mutates on the device, each stage's mutation pass one launch of
    ``csrc/resident_smc.cu`` for an architecture model (``extract_arch``),
    or of ``csrc/resident_smc_closure.cu``, generated from the closure, for
    a ``DistributionModel`` target with a base (``init_sampler`` and
    ``base_log_pdf``), as the JAX package traces the closure into its kernel.

    Returns ``(plan_or_None, reason)``; ``plan.chain_block`` is JAX's at
    ``platform="tpu"``: at most 4096 for up to 32 data rows, else (and for a
    closure) 1024. Explicit "resident" raises when ineligible, and "dense"
    always (SMC has one mutation kernel)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "scan":
        return None, "explicit backend='scan'"

    def fail(reason):
        if backend in ("resident", "dense"):
            raise ValueError(f"backend={backend!r} requested but ineligible: {reason}")
        return None, reason

    if backend == "dense":
        return fail("SMC has a resident mutation kernel only (particle clouds are iris-class "
                    "state); use backend='resident'")
    schedule = as_schedule(data)
    platform = platform or _platform(smc, schedule)
    if platform != "cuda":
        return fail(f"the kernel backend needs the model and data on a CUDA device "
                    f"(they are on {platform})")
    if smc.mutation not in ("MALA", "MH"):
        return fail(f"mutation {smc.mutation!r} has no kernel")
    model = smc.model
    if model.num_params > MAX_DISPATCH_PARAMS:
        return fail(f"{model.num_params} params > MAX_DISPATCH_PARAMS={MAX_DISPATCH_PARAMS}")
    if smc._is_bayesian:
        try:
            from eeyore_tpu_torch.ops.mlp_math import extract_arch
            extract_arch(model)
        except (ValueError, AttributeError) as err:
            return fail(f"model not kernel-compatible: {err}")
        cap = 4096 if schedule.x.shape[1] <= SMALL_MODEL_ROWS else 1024
    elif smc.base_log_pdf is None or smc.init_sampler is None:
        return fail("non-Bayesian targets need init_sampler + base_log_pdf for the geometric "
                    "path")
    else:
        cap = 1024
    cb = _pick_block(smc.num_particles, _RESIDENT_BLOCKS, cap=cap)
    if cb is None:
        return fail("resident SMC needs particles divisible by 128")
    from eeyore_tpu_torch.ops.resident_smc import make_resident_smc

    return _Plan("resident", make_resident_smc, dict(chain_block=cb), cb), None


def run_smc_backend(smc, generator, data, plan):
    """Execute a resolved SMC plan: build (and cache on the sampler) the
    runner, run it from a seed drawn from ``generator``, and re-wrap its
    outputs in ``SMCSampler.run``'s (state, diagnostics) contract, as the
    JAX package does: ``log_lik`` zeros, the final weight ESS in
    ``state.ess``, ``num_stages`` for adaptive runs only."""
    from eeyore_tpu_torch.samplers.smc import SMCState

    schedule = as_schedule(data)
    x, y = schedule.x[0], schedule.y[0]
    device = x.device
    xn, yn = x.cpu().numpy(), y.cpu().numpy()
    cache = getattr(smc, "_backend_cache", None)
    if cache is None:
        cache = smc._backend_cache = {}
    betas = "adaptive" if smc.adaptive else smc.betas.numpy()
    cache_key = (plan.maker.__name__, str(device), plan.chain_block, _freeze(betas),
                 smc.num_mutation_steps, smc.mutation, float(smc.mutation_step),
                 float(smc.ess_threshold), float(smc.adaptive_target_ess), int(smc.max_stages),
                 _data_fingerprint(xn, yn), _model_fingerprint(smc.model), id(smc.base_log_pdf),
                 id(smc.init_sampler))
    if cache_key not in cache:
        cache[cache_key] = plan.maker(
            smc.model, xn, yn, num_particles=smc.num_particles, betas=betas,
            num_mutation_steps=smc.num_mutation_steps, mutation=smc.mutation,
            mutation_step=smc.mutation_step, ess_threshold=smc.ess_threshold,
            adaptive_target_ess=smc.adaptive_target_ess, max_stages=smc.max_stages,
            init_sampler=smc.init_sampler, base_log_pdf=smc.base_log_pdf, device=device,
            **plan.kwargs)
    runner = cache[cache_key]

    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device if generator is not None else "cpu"))
    particles, log_w, diags = runner(seed)
    num_stages = int(diags.get("num_stages", len(diags["beta"])))
    final_beta = float(diags.pop("final_beta", 1.0))
    ess = float(diags.pop("final_weight_ess"))
    state = SMCState(particles=particles, log_weights=log_w,
                     log_lik=torch.zeros(smc.num_particles, dtype=torch.float32, device=device),
                     beta=torch.tensor(final_beta, dtype=torch.float32),
                     ess=torch.tensor(ess), unique_frac=diags["unique_frac"][num_stages - 1])
    return state, diags
