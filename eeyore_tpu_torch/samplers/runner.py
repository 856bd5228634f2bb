"""Chain runners: many chains at once, over iterations in a Python loop.

Counterpart of ``eeyore_tpu/samplers/runner.py``. ``num_iters`` counts all
iterations including burn-in (the reference's epochs x batches), of which
``num_burnin_iters`` are discarded; ``record_thin`` keeps the last state of
every block of ``record_thin`` post-burn-in iterations. Eligible
configurations go to the whole-loop kernel instead (``backend``, see
``samplers/dispatch.py``), which records the first state of each block.
Randomness comes from a ``torch.Generator`` in place of the JAX key: the
generic path draws from it directly, a kernel run draws its seed from it.
"""

import torch

from eeyore_tpu_torch.chains import ChainList, ChainLists
from eeyore_tpu_torch.datasets import as_schedule
from eeyore_tpu_torch.utils.profiling import JOB, spanned


def _check_thin(num_iters, num_burnin_iters, record_thin):
    kept_span = num_iters - num_burnin_iters
    if record_thin < 1 or kept_span % record_thin:
        raise ValueError(
            f"record_thin={record_thin} must divide the {kept_span} "
            "post-burn-in iterations")


def _generator_or_default(generator, device):
    """``generator``, or when it is None the global generator of ``device``,
    the one that ``torch.randn(..., generator=None)`` draws from."""
    if generator is not None:
        return generator
    device = torch.device(device)
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        return torch.cuda.default_generators[index]
    return torch.default_generator


def _run_generic(kernel, generator, theta0s, schedule, num_iters, num_burnin_iters,
                 record_keys, record_thin, on_iteration=None):
    """Python loop over iterations; returns (final_state, {key: [C, kept, ...]}).
    ``on_iteration(i, state)``, when given, is called after iteration i."""
    kernel.init_schedule = schedule
    xb, yb = schedule.batch(0)
    # the generic path always hands init a generator, as the JAX runner hands
    # it a key; only the kernel path's final state is made without one
    state = kernel.init(theta0s, xb, yb,
                        generator=_generator_or_default(generator, theta0s.device))
    rows = {k: [] for k in record_keys}
    for i in range(num_iters):
        xb, yb = schedule.batch(i)
        state, info = kernel.step(state, xb, yb, i, generator=generator)
        since = i - num_burnin_iters
        if since >= 0 and since % record_thin == record_thin - 1:
            for k in record_keys:
                rows[k].append(info[k])
        if on_iteration is not None:
            on_iteration(i, state)
    recorded = {k: torch.stack(v, dim=1) if v else None for k, v in rows.items()}
    return state, recorded


def _resolve_auto_budget(kernel, generator, schedule, theta0s):
    """NUTS with ``max_depth="auto"``: probe the depth and step on this data
    before dispatch (the probe's seed from ``generator``); the run's inits go
    to the probe of a prior-less model only."""
    if getattr(kernel, "auto_depth", False):
        kernel.resolve_auto_budget(
            schedule, generator,
            theta0s=theta0s if not hasattr(kernel.model, "prior") else None)


def _prepare(kernel, theta0s, data, num_iters, num_burnin_iters, record_thin):
    theta0s = torch.as_tensor(theta0s)
    model_dtype = getattr(kernel.model, "dtype", None)
    if not theta0s.is_floating_point() and model_dtype is not None:
        theta0s = theta0s.to(model_dtype)
    schedule = as_schedule(data).to(device=theta0s.device, dtype=theta0s.dtype)
    _check_thin(num_iters, num_burnin_iters, record_thin)
    return theta0s, schedule


@spanned(JOB)
def sample_chains(kernel, generator, theta0s, data, num_iters, num_burnin_iters=0,
                  record_keys=None, return_state=False, return_arrays=False,
                  record_thin=1, backend="auto", platform=None):
    """Run many chains at once.

    ``theta0s``: [num_chains, num_params] on the device to run on; ``data``
    is moved there. Returns a ``ChainLists`` (or the stacked tensors
    {key: [num_chains, kept_iters, ...]} with ``return_arrays=True``), and
    the final state with ``return_state=True``.

    ``backend``: "auto" (default) sends eligible configurations whose model
    and data live on a CUDA device to a whole-loop kernel
    (``samplers/dispatch.py``: the dense kernel for at most 32 data rows, else
    the resident one); "scan" forces the generic path; "resident" and
    "dense" demand that kernel and raise when ineligible. Kernel runs record
    sample/accepted (and target_val when asked) and draw their own numbers
    from a seed taken from ``generator``. ``platform`` overrides the device
    type that dispatch sees ("cuda" or "cpu"); a CUDA plan on CPU tensors
    runs the kernel's plain version.

    Each call is the span ``eeyore.sample_chains`` (``utils/profiling.py``),
    whose kernel path holds the spans of its layers; the generic path has
    none of its own.

    ``accepted`` is per chain and iteration, [C, kept], except on the generic
    path of ``Gibbs``, which records one flag per sub-block, [C, kept, B];
    a Gibbs kernel run records whether the sweep moved, [C, kept], as in the
    JAX package, and leaves its per-sub-block accept counts [C, B] in the
    kernel module's ``last_info`` (``ops/resident_walk.py``,
    ``ops/resident_walk_dense.py``).
    """
    theta0s, schedule = _prepare(kernel, theta0s, data, num_iters, num_burnin_iters,
                                 record_thin)
    _resolve_auto_budget(kernel, generator, schedule, theta0s)
    if backend != "scan":
        from eeyore_tpu_torch.samplers.dispatch import resolve_backend, run_kernel_backend

        plan, _reason = resolve_backend(
            kernel, schedule, theta0s.shape[0], num_iters, num_burnin_iters, record_thin,
            backend=backend, platform=platform, record_keys=record_keys)
        if plan is not None:
            kernel.recompute_current = False
            kernel.num_burnin_iters = num_burnin_iters
            recorded, info = run_kernel_backend(
                kernel, generator, theta0s, schedule, num_iters, num_burnin_iters, plan,
                record_thin,
                needs_accepted=record_keys is None or "accepted" in record_keys)
            if record_keys is not None:
                recorded = {k: v for k, v in recorded.items() if k in record_keys}
            result = recorded if return_arrays else ChainLists.from_arrays(recorded)
            if not return_state:
                return result
            xb, yb = schedule.batch(0)
            state = kernel.init(info["final"].to(theta0s.dtype), xb, yb)
            return result, state

    kernel.recompute_current = schedule.num_batches != 1
    kernel.num_burnin_iters = num_burnin_iters  # gates the in-loop tuning (HMC)
    record_keys = tuple(record_keys or kernel.state_keys)
    state, recorded = _run_generic(kernel, generator, theta0s, schedule, num_iters,
                                   num_burnin_iters, record_keys, record_thin)
    result = recorded if return_arrays else ChainLists.from_arrays(recorded)
    return (result, state) if return_state else result


def sample_chain(kernel, generator, theta0, data, num_iters, num_burnin_iters=0,
                 record_keys=None, return_state=False, record_thin=1, backend="auto",
                 platform=None):
    """Run one chain; returns a ``ChainList`` of the post-burn-in states (and
    the final state of the one chain, as a state of one chain, with
    ``return_state=True``).

    On the kernel path the kernel runs one block of ``chain_block`` chains
    from this ``theta0`` (they differ through their draws) and chain 0 is
    returned, as the JAX package does.
    """
    theta0 = torch.as_tensor(theta0)
    if backend != "scan":
        from eeyore_tpu_torch.samplers.dispatch import resolve_backend

        theta0s, schedule = _prepare(kernel, theta0[None], data, num_iters,
                                     num_burnin_iters, record_thin)
        _resolve_auto_budget(kernel, generator, schedule, theta0s)
        plan, _reason = resolve_backend(
            kernel, schedule, 1024, num_iters, num_burnin_iters, record_thin,
            backend=backend, platform=platform, record_keys=record_keys)
        if plan is not None:
            block = theta0s.expand(plan.chain_block, -1).contiguous()
            out = sample_chains(kernel, generator, block, schedule, num_iters,
                                num_burnin_iters, record_keys=record_keys,
                                return_state=return_state, return_arrays=True,
                                record_thin=record_thin, backend=backend,
                                platform=platform)
            recorded, state = out if return_state else (out, None)
            chain = ChainList.from_arrays({k: v[0] for k, v in recorded.items()})
            if not return_state:
                return chain
            return chain, type(state)(*(_first(v) for v in state))
    out = sample_chains(kernel, generator, theta0[None], data, num_iters, num_burnin_iters,
                        record_keys=record_keys, return_state=return_state,
                        return_arrays=True, record_thin=record_thin, backend="scan")
    recorded, state = out if return_state else (out, None)
    chain = ChainList.from_arrays({k: v[0] for k, v in recorded.items()})
    return (chain, state) if return_state else chain


def _first(value):
    """Chain 0 of a state field (kept as a batch of one)."""
    if isinstance(value, tuple):
        return type(value)(*(_first(v) for v in value))
    return value[:1]
