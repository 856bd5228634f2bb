"""The whole HMC loop of a population of MLP chains in one kernel.

Counterpart of ``eeyore_tpu/ops/resident_hmc.py``. ``make_resident_hmc``
returns ``fn(seed, theta0s [C, P]) -> (samples [kept, C, P], final [C, P],
accept_counts [C])``, plus ``target_val [kept, C]`` and ``accepted [kept, C]``
(int32) with ``record_extras``. On CUDA tensors every call is one launch of
``ops/csrc/resident_hmc.cu``, a chain on ``HMC_LANES`` lanes of a warp
(``csrc/lane_eval.cuh``; one thread a chain on data of few rows,
``chain_lanes``); on CPU tensors it runs the plain version
below, a PyTorch loop over iterations and leapfrog steps on ``[P, C]`` with
``mlp_math.make_vg``, the same Threefry stream (``kernel_prng.hmc_draws``)
and the same population tuner algebra. There is no fallback from one to the
other: the kernel's wrapper ``resident_hmc`` raises on anything but CUDA
tensors.

With a ``tuner`` (an ``HMCDATuner``), dual averaging runs inside the loop
during burn-in on the mean acceptance rate of each block of ``chain_block``
chains, the l-rule sets the trajectory length (capped at ``max_num_steps``),
and the last burn-in iteration freezes the averaged step. ``l_rounding=
"stochastic"`` freezes per-chain trajectory lengths ``floor(l/e) +
Bernoulli(frac(l/e))``. On the card a tuning group is one CUDA block or,
where the build's registers let no block hold it, a thread-block cluster of
up to ``MAX_CLUSTER`` blocks, at any lane count (``launch_threads``); a
``chain_block`` that the card cannot hold so raises ValueError. The default,
2048 chains, is JAX's. The plain version takes any group.

The TPU kernel's schedule knobs (``stream``, ``mxu_layer0``,
``matmul_precision``, ``vmem_limit_bytes``) have no counterpart: the CUDA
body streams the data rows one at a time. Only their defaults are accepted.

Every call counts the single-chain value-and-gradient evaluations it made
(on the card, a device counter the kernel adds to; on the CPU, the plain
version's count) and leaves them in ``last_info[KERNEL]["evaluations"]``, a
0-d int64 tensor on the call's device: a run's bound follows from it.
``_run_plain`` is shared with ``ops/resident_hmc_dense.py``.
"""

import ctypes

import numpy as np
import torch

from eeyore_tpu_torch.ops import _build, kernel_prng
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_math import extract_arch, make_vg, prepare_data

KERNEL = "resident_hmc"
# Most threads of one CUDA block.
MAX_BLOCK = 1024
# Threads per block of an untuned run, where blocks share nothing.
UNTUNED_BLOCK = 256
# Lanes of a warp a chain of the staged HMC kernel (1, 2, 4 or 8), and the
# blocks an SM must hold at once (of 256 x HMC_LANES threads, a tuning group
# of 256 chains, at up to 4 lanes; of 256 threads at 8), which caps the
# registers the compiler may use: the fastest that scripts/lane_sweep.py
# measured on the H100 (PERF.md, section 6).
HMC_LANES = 2
HMC_MIN_BLOCKS = 1
LANE_COUNTS = (1, 2, 4, 8)
# Fewest staged data rows (padded) on which a chain takes lanes: on fewer
# (XOR's 8) a lane would get next to no rows to split, and one thread a chain
# runs.
LANE_MIN_ROWS = 32
# Most blocks of a thread-block cluster on Hopper (with the non-portable
# attribute; 8 without).
MAX_CLUSTER = 16

# Launches of each kernel of this module, counted where they happen.
launch_counts = {KERNEL: 0}
# What the last call of each kernel's function reported ({"evaluations": ...}).
last_info = {KERNEL: None}


class ResidentHMCParams(ctypes.Structure):
    """The HMC kernels' scalar arguments (``ResidentHMCParams`` in
    ``csrc/resident_loop.cuh``), shared with ``resident_hmc_dense``."""

    _fields_ = ([(name, ctypes.c_int) for name in (
        "seed", "num_chains", "n_rows", "num_iters", "num_burnin_iters", "record_thin",
        "kept", "num_steps", "tuned", "stochastic", "max_num_steps", "record_extras",
        "per_chain", "use_l", "nan_guard", "sublanes", "chain_block")]
        + [(name, ctypes.c_float) for name in (
            "step", "tuner_m", "d", "g", "t0", "k", "l", "log_eub", "prior_const",
            "temperature")])


def hmc_params(step, num_steps, num_iters, num_burnin_iters, record_thin, tuner,
               max_num_steps, l_rounding, record_extras, chain_block, n_rows=0,
               prior_const=0.0, temperature=1.0, per_chain=False):
    """A filled ``ResidentHMCParams`` (without seed and chain count)."""
    f32 = np.float32
    use_l = tuner is not None and tuner.l is not None
    params = ResidentHMCParams(
        num_chains=0, n_rows=n_rows, num_iters=num_iters, num_burnin_iters=num_burnin_iters,
        record_thin=record_thin, kept=(num_iters - num_burnin_iters) // record_thin,
        num_steps=int(num_steps), tuned=int(tuner is not None),
        stochastic=int(use_l and l_rounding == "stochastic"),
        max_num_steps=int(max_num_steps), record_extras=int(record_extras),
        per_chain=int(tuner is not None and per_chain), use_l=int(use_l), sublanes=1,
        chain_block=chain_block, step=float(step),
        tuner_m=float(np.log(f32(10.0) * f32(step))), prior_const=prior_const,
        temperature=temperature)
    if tuner is not None:
        params.d, params.g, params.t0, params.k = tuner.d, tuner.g, tuner.t0, tuner.k
        params.l = 0.0 if tuner.l is None else tuner.l
        params.log_eub = np.inf if tuner.eub is None else float(f32(np.log(tuner.eub)))
    return params


def check_lanes(lanes):
    """``lanes`` as an int, if it is a lane count a chain of the staged HMC,
    MH and MALA kernels (1, 2, 4 or 8): else ValueError."""
    if int(lanes) not in LANE_COUNTS:
        raise ValueError(f"a chain of the staged HMC, MH and MALA kernels takes 1, 2, 4 or 8 "
                         f"lanes, not {lanes}")
    return int(lanes)


def block_threads(lanes):
    """Threads a block of the staged HMC build on ``lanes`` lanes may have
    (its launch bounds): one thread a chain 1024; up to 4 lanes a tuning
    group of 256 chains; 8 lanes 256 (a group of 256 chains is a cluster)."""
    return MAX_BLOCK if lanes == 1 else (256 * lanes if lanes <= 4 else 256)


def chain_lanes(n_rows, chain_block, tuned):
    """Lanes a chain of the staged HMC build for ``n_rows`` staged (padded)
    rows and ``chain_block``-chain groups: ``HMC_LANES``, or 1 (one thread a
    chain) on fewer than ``LANE_MIN_ROWS`` rows, where a lane would get no
    rows to split, or for a tuning group larger than a cluster of
    ``MAX_CLUSTER`` lane blocks holds."""
    lanes = check_lanes(HMC_LANES)
    if n_rows < LANE_MIN_ROWS:
        return 1
    if tuned and chain_block * lanes > MAX_CLUSTER * block_threads(lanes):
        return 1
    return lanes


def library_spec(model, lanes=None):
    """(name, source, defines) of the staged HMC build for ``model`` on
    ``lanes`` lanes a chain (``HMC_LANES`` by default) at ``HMC_MIN_BLOCKS``:
    the arguments of ``_build.load_library``."""
    lanes = check_lanes(HMC_LANES if lanes is None else lanes)
    tag, defines = arch_defines(model)
    return (f"{KERNEL}_{tag}_l{lanes}_b{HMC_MIN_BLOCKS}", "resident_hmc.cu",
            tuple(defines) + (f"HMC_LANES={lanes}", f"HMC_MIN_BLOCKS={HMC_MIN_BLOCKS}"))


def load_kernel(model, lanes=None):
    """Build (at first use) and load the resident HMC kernel for ``model``'s
    architecture and ``lanes`` lanes a chain (``HMC_LANES``, or 1:
    ``chain_lanes``), which it takes as compile-time constants."""
    name, source, defines = library_spec(model, lanes)
    lib = _build.load_library(name, source, defines)
    lib.resident_hmc_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.POINTER(ResidentHMCParams), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 5)
    lib.resident_hmc_launch.restype = ctypes.c_int
    lib.resident_hmc_error_string.argtypes = [ctypes.c_int]
    lib.resident_hmc_error_string.restype = ctypes.c_char_p
    for fn in (lib.resident_hmc_arch, lib.resident_hmc_resources):
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    lib.resident_hmc_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int)]
    lib.resident_hmc_max_clusters.restype = ctypes.c_int
    lib.resident_hmc_max_blocks.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
    lib.resident_hmc_max_blocks.restype = ctypes.c_int
    lib.resident_hmc_lanes.argtypes = []
    lib.resident_hmc_lanes.restype = ctypes.c_int
    check_arch(lib.resident_hmc_arch, model, name)
    return lib


def check_arch(arch_fn, model, name):
    """Raise unless the library's ``*_arch`` reports ``model``'s parameter
    count, input and output widths and loss, and blocks of up to
    ``MAX_BLOCK`` threads (every whole-loop kernel reports these five)."""
    dims, _, loss_kind, _ = extract_arch(model)
    arch = (ctypes.c_int * 5)()
    arch_fn(arch)
    expected = [model.num_params, dims[0], dims[-1], int(loss_kind == "ce"), MAX_BLOCK]
    if list(arch) != expected:
        raise RuntimeError(f"{name}: library built for {list(arch)}, model needs {expected}")


def raise_on(err, error_string, what):
    """Raise on a non-zero CUDA error code from a library call."""
    if err != 0:
        raise RuntimeError(f"{what}: {error_string(err).decode()}")


def read_resources(call, error_string, name):
    """Registers and local-memory (spill) bytes per thread of a loaded
    kernel, and the most threads its blocks can have with those registers,
    from a ``*_resources`` call taking the int[3] to fill."""
    out = (ctypes.c_int * 3)()
    raise_on(call(out), error_string, name)
    return {"registers": out[0], "local_bytes": out[1], "max_threads_per_block": out[2]}


def kernel_resources(lib):
    """``read_resources`` of the loaded resident HMC kernel."""
    return read_resources(lib.resident_hmc_resources, lib.resident_hmc_error_string, KERNEL)


def max_active_clusters(lib, threads, blocks, n_rows):
    out = ctypes.c_int(0)
    raise_on(lib.resident_hmc_max_clusters(threads, blocks, n_rows, ctypes.byref(out)),
             lib.resident_hmc_error_string, KERNEL)
    return out.value


def max_active_blocks(lib, threads, n_rows):
    """Blocks of ``threads`` threads of this build that an SM holds at once,
    for ``n_rows`` staged rows, as the card's occupancy calculator says."""
    out = ctypes.c_int(0)
    raise_on(lib.resident_hmc_max_blocks(threads, n_rows, ctypes.byref(out)),
             lib.resident_hmc_error_string, KERNEL)
    return out.value


def launch_threads(lib, chain_block, n_rows, tuned):
    """(threads a block, blocks a cluster) of a launch of this build:
    ``launch_shape`` of a group's ``chain_block`` x lanes threads, in one
    block or a cluster the card holds when tuned (ValueError where none
    does), in blocks of up to ``UNTUNED_BLOCK`` threads that cover the
    chains exactly when not."""
    from eeyore_tpu_torch.ops.resident_hmc_dense import launch_shape

    return launch_shape(kernel_resources(lib),
                        lambda t, b: max_active_clusters(lib, t, b, n_rows),
                        chain_block * lib.resident_hmc_lanes(), grouped=tuned)


def hmc_launch(lib, num_chains, chain_block, n_rows, tuned, sm_count=None):
    """``lane_launch`` of this build for ``num_chains`` chains in groups of
    ``chain_block``: lanes, threads, blocks, cluster, the card's occupancy
    and the SMs covered."""
    from eeyore_tpu_torch.ops.resident_hmc_dense import lane_launch

    return lane_launch(num_chains, lib.resident_hmc_lanes(), kernel_resources(lib), chain_block,
                       lambda t: max_active_blocks(lib, t, n_rows),
                       lambda t, b: max_active_clusters(lib, t, b, n_rows), tuned, sm_count)


def resident_hmc(lib, theta0, x, y, mask, loc, ivar, params, threads, cluster_blocks=1):
    """Launch the kernel: theta0 [P, C] -> (samples [kept, rows, C], final
    [P, C], accepts [C], {"evaluations": int64 0-d tensor}), f32 on one CUDA
    device, on the current stream. ``params`` is a filled
    ``ResidentHMCParams``; rows = P (+2 with record_extras); a tuning group
    on lanes takes ``cluster_blocks`` blocks of ``threads``."""
    P, C = theta0.shape
    for t in (theta0, x, y, mask, loc, ivar):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("resident_hmc takes contiguous float32 CUDA tensors")
        if t.device != theta0.device:
            raise ValueError("resident_hmc takes its tensors on one device")
    if params.num_chains != C or params.n_rows != x.shape[0] or loc.numel() != P:
        raise ValueError("resident_hmc: inconsistent shapes")
    max_threads = kernel_resources(lib)["max_threads_per_block"]
    if threads > max_threads:
        raise ValueError(f"resident_hmc: blocks of {threads} threads, but this build's "
                         f"registers allow {max_threads}")
    rows = P + 2 if params.record_extras else P
    samples = torch.empty((params.kept, rows, C), dtype=torch.float32, device=theta0.device)
    final = torch.empty((P, C), dtype=torch.float32, device=theta0.device)
    accepts = torch.empty((C,), dtype=torch.float32, device=theta0.device)
    evaluations = torch.zeros((), dtype=torch.int64, device=theta0.device)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_hmc_launch(
        theta0.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(), loc.data_ptr(),
        ivar.data_ptr(), ctypes.byref(params), threads, cluster_blocks, samples.data_ptr(),
        final.data_ptr(), accepts.data_ptr(), evaluations.data_ptr(), stream)
    raise_on(err, lib.resident_hmc_error_string, f"{KERNEL} launch failed")
    launch_counts[KERNEL] += 1
    return samples, final, accepts, {"evaluations": evaluations}


def _population_tune(pr, t, barh, logbare, mean_rate):
    """The in-loop dual averaging of every tuning group at iteration ``t``
    (resident_hmc.py:184-218), in float32: returns (barh, logbare, step),
    each [groups]; the last burn-in iteration returns the averaged step."""
    it = torch.tensor(t + 1, dtype=torch.float32, device=barh.device)
    d_w = 1.0 / (it + pr.t0)
    e_w = torch.exp(-pr.k * torch.log(it))  # it ** -k
    barh = (1.0 - d_w) * barh + d_w * (pr.d - mean_rate)
    loge = torch.clamp(pr.tuner_m - torch.sqrt(it) * barh / pr.g, max=pr.log_eub)
    logbare = e_w * loge + (1.0 - e_w) * logbare
    last = t == pr.num_burnin_iters - 1
    return barh, logbare, torch.exp(logbare) if last else torch.exp(loge)


def group_index(C, chain_block, sublanes):
    """Each chain's tuning group, [C] int64: runs of ``chain_block``
    consecutive chains (``sublanes`` 1), or the TPU dense layout's
    sublane-strided sets (``sublanes`` 8: chain ``s*(C/8) + i*lb + j`` is in
    group ``i``, ``lb = chain_block/8``)."""
    c = torch.arange(C)
    return (c % (C // sublanes)) // (chain_block // sublanes)


def group_means(v, chain_block, sublanes):
    """The mean of ``v`` [C] over each tuning group (see ``group_index``)."""
    groups = v.shape[0] // chain_block
    return v.reshape(sublanes, groups, -1).transpose(0, 1).reshape(groups, -1).mean(dim=1)


def _run_plain(vg, arrays, pr, chain_block, theta):
    """The HMC kernels' computation in PyTorch, on [P, C] tensors: same
    inputs and outputs as ``resident_hmc``, plus {"evaluations": the
    single-chain value-and-gradient evaluations the run needed (a 0-d
    tensor), "step" and "num_steps": each chain's final step and trajectory
    length, [C]}. ``pr`` picks the tuning: population groups of
    ``chain_block`` chains (``pr.sublanes`` lays them out) or per chain,
    with or without the l-rule and the NaN guard."""
    P, C = theta.shape
    f32 = dict(dtype=torch.float32, device=theta.device)
    chains = torch.arange(C, dtype=torch.int64, device=theta.device)
    val, grad = vg(theta, *arrays)
    val = val[0]
    step = torch.full((C,), pr.step, **f32)
    n_steps = torch.full((C,), pr.num_steps, dtype=torch.int32, device=theta.device)
    per_chain = bool(pr.per_chain)
    tuned_shape = C if per_chain else C // chain_block
    gid = group_index(C, chain_block, pr.sublanes).to(theta.device)
    barh = torch.zeros(tuned_shape, **f32)
    logbare = torch.zeros(tuned_shape, **f32)
    rows = P + 2 if pr.record_extras else P
    samples = torch.empty((pr.kept, rows, C), **f32)
    accepts = torch.zeros(C, **f32)
    evaluations = torch.tensor(C, device=theta.device)

    for t in range(pr.num_iters):
        mom, u_accept, u_round = kernel_prng.hmc_draws(pr.seed, chains, t, P)
        h_cur = -val + 0.5 * torch.sum(mom * mom, dim=0)
        th, g, v = theta, grad, val
        p = mom + (0.5 * step) * g
        # per-chain trajectory lengths: run to the longest, finished chains frozen
        for s in range(int(n_steps.max()) if C else 0):
            active = s < n_steps
            evaluations = evaluations + active.sum()
            th_s = th + step * p
            v_s, g_s = vg(th_s, *arrays)
            f = torch.where(n_steps - 1 == s, 0.5, 1.0) * step
            p_s = p + f * g_s
            th = torch.where(active, th_s, th)
            p = torch.where(active, p_s, p)
            v = torch.where(active, v_s[0], v)
            g = torch.where(active, g_s, g)
        h_prop = -v + 0.5 * torch.sum(p * p, dim=0)
        rate = torch.clamp(torch.exp(h_cur - h_prop), max=1.0)
        accept = u_accept < rate
        moved = accept & torch.any(th != theta, dim=0)
        theta = torch.where(accept, th, theta)
        grad = torch.where(accept, g, grad)
        val = torch.where(accept, v, val)
        if t >= pr.num_burnin_iters:
            accepts += accept.to(torch.float32)

        if pr.tuned and t < pr.num_burnin_iters:
            stat = rate if per_chain else group_means(rate, chain_block, pr.sublanes)
            if pr.nan_guard:
                stat = torch.where(torch.isnan(stat), 0.0, stat)
            barh, logbare, new_step = _population_tune(pr, t, barh, logbare, stat)
            step = new_step if per_chain else new_step[gid]
            if pr.use_l:
                ratio = pr.l / step
                n = torch.round(ratio)
                if pr.stochastic and t == pr.num_burnin_iters - 1:
                    n_lo = torch.floor(ratio)
                    n = n_lo + (u_round < ratio - n_lo).to(torch.float32)
                n_steps = torch.clamp(n, 1, pr.max_num_steps).to(torch.int32)

        since = t - pr.num_burnin_iters
        if since >= 0 and since % pr.record_thin == 0 and since // pr.record_thin < pr.kept:
            out = samples[since // pr.record_thin]
            out[:P] = theta
            if pr.record_extras:
                out[P] = val
                out[P + 1] = moved.to(torch.float32)
    return samples, theta, accepts, {"evaluations": evaluations, "step": step,
                                     "num_steps": n_steps}


def make_resident_hmc(model, x, y, step, num_steps, num_iters, num_burnin_iters=0,
                      chain_block=2048, record_thin=1, tuner=None, max_num_steps=64,
                      stream=None, vmem_limit_bytes=None, mxu_layer0=None,
                      matmul_precision=None, l_rounding="round", record_extras=False,
                      device="cuda"):
    """Build ``fn(seed, theta0s [C, P]) -> (samples [kept, C, P], final [C,
    P], accept_counts [C])`` running the whole HMC loop, with ``kept =
    (num_iters - num_burnin_iters) // record_thin``; with ``record_extras``
    also ``target_val [kept, C]`` and ``accepted [kept, C]`` (int32, exact
    moved flags). C must be a multiple of ``chain_block``. ``device`` is
    where the data lives and the tensors ``fn`` takes: on a CUDA device
    every call launches the kernel (a tuned ``chain_block`` that no block or
    cluster of the card holds raises ValueError here), on the CPU it runs
    the plain version. The samples come back as a transposed view of the
    kernel's chain-minor output."""
    for name, value in (("stream", stream), ("vmem_limit_bytes", vmem_limit_bytes),
                        ("mxu_layer0", mxu_layer0), ("matmul_precision", matmul_precision)):
        if value is not None:
            raise ValueError(f"{name} is a TPU schedule setting with no CUDA counterpart; "
                             "leave it None")
    if l_rounding not in ("round", "stochastic"):
        raise ValueError(f"l_rounding must be 'round' or 'stochastic', got {l_rounding!r}")
    if tuner is not None and tuner.l is None:
        raise ValueError("the in-loop tuner needs the trajectory length l (HMCDATuner(l=...))")
    device = torch.device(device)
    x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature = prepare_data(model, x, y)
    P = model.num_params
    params = hmc_params(step, num_steps, num_iters, num_burnin_iters, record_thin, tuner,
                        max_num_steps, l_rounding, record_extras, chain_block,
                        n_rows=x_pad.shape[0], prior_const=prior_const,
                        temperature=temperature)
    arrays = [torch.as_tensor(a, device=device).contiguous()
              for a in (x_pad, y_pad, row_mask, loc, ivar)]
    n_rows = x_pad.shape[0]
    lib, shape = None, None
    if device.type == "cuda":
        if chain_block % 32 != 0:
            raise ValueError(f"on the card chain_block must be a multiple of 32, "
                             f"got {chain_block}")
        lib = load_kernel(model, chain_lanes(n_rows, chain_block, tuner is not None))
        shape = launch_threads(lib, chain_block, n_rows, tuner is not None)
    vg = make_vg(model, x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature)

    def setup(seed, theta0s):
        C = theta0s.shape[0]
        if C % chain_block != 0:
            raise ValueError(f"{C} chains not a multiple of chain_block {chain_block}")
        pr = ResidentHMCParams.from_buffer_copy(params)
        pr.seed, pr.num_chains = int(seed), C
        return pr, theta0s.to(torch.float32).T.contiguous()  # [P, C]

    def fn(seed, theta0s):
        if theta0s.device.type != device.type:
            raise ValueError(f"theta0s on {theta0s.device}, but the function was built for "
                             f"device={device}")
        pr, theta_t = setup(seed, theta0s)
        if lib is None:
            samples, final, acc, info = _run_plain(vg, arrays, pr, chain_block, theta_t)
        else:
            samples, final, acc, info = resident_hmc(lib, theta_t, *arrays, pr, *shape)
        last_info[KERNEL] = {"evaluations": info["evaluations"]}
        return unpack_outputs(samples, final, acc, P, record_extras)

    def plain(seed, theta0s):
        """The plain version on ``device``'s tensors, whichever the device:
        ``fn``'s outputs and a dict of the run's single-chain evaluation
        count ("evaluations", an int) and each chain's final "step" and
        "num_steps". For holding the kernel against it on the card."""
        pr, theta_t = setup(seed, theta0s)
        samples, final, acc, info = _run_plain(vg, arrays, pr, chain_block, theta_t)
        return (unpack_outputs(samples, final, acc, P, record_extras),
                dict(info, evaluations=int(info["evaluations"])))

    fn.plain = plain
    fn.hmc_launch = lambda C, sm_count=None: (
        None if lib is None else hmc_launch(lib, C, chain_block, n_rows, tuner is not None,
                                            sm_count))
    return fn


def unpack_outputs(samples, final, acc, P, record_extras):
    """The kernels' [kept, rows, C] samples and [P, C] final state as
    ``(samples [kept, C, P], final [C, P], acc [C](, target_val [kept, C],
    accepted [kept, C] int32))``, views where they can be."""
    out = (samples[:, :P, :].transpose(1, 2), final.T, acc)
    if record_extras:
        out = out + (samples[:, P, :], samples[:, P + 1, :].to(torch.int32))
    return out
