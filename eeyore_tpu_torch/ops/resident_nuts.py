"""The whole fixed-budget NUTS loop of a population of MLP chains in one
kernel, on staged data.

Counterpart of ``eeyore_tpu/ops/resident_nuts.py``. ``make_resident_nuts``
returns ``fn(seed, theta0s [C, P]) -> (samples [kept, C, P], final [C, P],
accept_sums [C], divergent_sums [C])``: the post-burn-in sums of each
transition's trajectory-mean Metropolis statistic and divergence flag; with
``record_extras`` also ``target_val [kept, C]`` and ``accepted [kept, C]``
(int32, exact moved flags). On CUDA tensors every call is one launch of
``ops/csrc/resident_nuts.cu``, built for the model's architecture and the
depth; on CPU tensors it runs the plain version below, a PyTorch loop over
iterations, depths and leaves on ``[P, C]`` with ``mlp_math.make_vg``, the
NUTS stream of ``kernel_prng.nuts_draws`` and the population tuner algebra.
There is no fallback from one to the other: the kernel's wrapper
``resident_nuts`` raises on anything but CUDA tensors.

Every transition runs exactly ``2**max_depth - 1`` leapfrog steps: a chain
whose trajectory has stopped runs its remaining leaves with weight -inf and
its statistics and flags gated, the masked algebra of JAX's
``samplers/nuts.py::_tree_fixed``. With a ``tuner`` (an ``HMCDATuner``
without ``l``), one step per tuning group of ``chain_block`` consecutive
chains is dual-averaged on the group mean of accept_stat (a NaN mean counts
as 0) during burn-in, from ``m = log(10 step)``; the last burn-in iteration
freezes the averaged step. On the card a chain is ``NUTS_LANES`` lanes of a
warp, its tree state spread over them (``csrc/lane_eval.cuh``), and a tuning
group of ``chain_block`` chains is one CUDA block, or a thread-block cluster
when it is larger than a block can be; a group larger than a cluster of lane
blocks holds (``LANE_GROUP_CAP``) takes the build with one thread a chain.

``inv_mass``: an optional frozen diagonal of M^-1 [P]: momenta ~ N(0, M),
positions move at M^-1 rho, kinetic energy and U-turns on velocities. No
metric is the all-ones metric, with the same samples.

The TPU kernel's schedule knobs (``stream``, ``mxu_layer0``,
``matmul_precision``, ``vmem_limit_bytes``) have no counterpart: the CUDA
body streams the data rows one at a time. Only their defaults are accepted.
``_run_nuts_plain`` is shared with ``ops/resident_nuts_dense.py``.
"""

import ctypes
import math

import numpy as np
import torch

from eeyore_tpu_torch.ops import _build, kernel_prng
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_math import make_vg, prepare_data
from eeyore_tpu_torch.ops.resident_hmc import (
    ResidentHMCParams,
    _population_tune,
    check_arch,
    group_index,
    group_means,
    hmc_params,
    raise_on,
    read_resources,
)
from eeyore_tpu_torch.ops.resident_hmc_dense import MAX_CLUSTER, lane_launch, launch_shape

KERNEL = "resident_nuts"
DIVERGENCE_THRESHOLD = 1000.0
# Lanes of a warp a chain, and the blocks of at most 16 x NUTS_LANES threads
# an SM must hold at once, which caps the registers the compiler may use
# (more resident warps at the price of a few spills): the fastest that
# scripts/lane_sweep.py measured on the H100 (PERF.md, section 6).
NUTS_LANES = 8
NUTS_MIN_BLOCKS = 5
# The largest tuning group on lanes: a cluster of MAX_CLUSTER blocks of 16
# chains. A larger group (JAX's up to 4096 chains on small data) takes the
# build with one thread a chain (``chain_lanes``).
LANE_GROUP_CAP = MAX_CLUSTER * 16

launch_counts = {KERNEL: 0}
# What the last call of the kernel's function returned beside the samples,
# and each chain's final step (the tuned step of its group):
# {"accept_sums": [C], "divergent_sums": [C], "step": [C]} (sample_chains
# keeps only the samples).
last_info = {KERNEL: None}


def nuts_params(step, num_iters, num_burnin_iters, record_thin, tuner, record_extras,
                chain_block, sublanes, n_rows=0, prior_const=0.0, temperature=1.0):
    """A filled ``ResidentHMCParams`` for the NUTS kernels (without seed and
    chain count): population tuning with the NaN guard, ``m = log(10
    step)`` rounded from float64 as the TPU kernels take it."""
    params = hmc_params(step, 1, num_iters, num_burnin_iters, record_thin, tuner, 1, "round",
                        record_extras, chain_block, n_rows=n_rows, prior_const=prior_const,
                        temperature=temperature)
    params.tuner_m = float(np.float32(math.log(10.0 * float(step))))
    params.nan_guard, params.sublanes = 1, sublanes
    return params


def check_nuts_args(max_depth, tuner):
    """The makers' shared argument checks (JAX's)."""
    if int(max_depth) < 1:
        raise ValueError("max_depth must be >= 1")
    if tuner is not None and tuner.l is not None:
        raise ValueError("NUTS chooses its own trajectory length; construct the tuner "
                         "without l (HMCDATuner())")


def metric_arrays(inv_mass, P):
    """(inv_mass, 1 / sqrt(inv_mass)) as float32 numpy [P]: ones for no
    metric; a non-positive entry raises."""
    if inv_mass is None:
        return np.ones(P, np.float32), np.ones(P, np.float32)
    im = np.asarray(inv_mass, np.float32).reshape(P)
    if np.any(im <= 0):
        raise ValueError("inv_mass must be positive")
    return im, (1.0 / np.sqrt(im)).astype(np.float32)


def chain_lanes(chain_block, tuned):
    """Lanes a chain of the build that runs ``chain_block``-chain groups:
    ``NUTS_LANES``, or 1 (one thread a chain) for a tuning group larger
    than ``LANE_GROUP_CAP``, which no cluster of lane blocks holds."""
    return 1 if tuned and chain_block > LANE_GROUP_CAP else NUTS_LANES


def load_kernel(model, max_depth, lanes):
    """Build (at first use) and load the staged NUTS kernel for ``model``'s
    architecture, the tree depth and ``lanes`` lanes a chain (``NUTS_LANES``,
    or 1: ``chain_lanes``), which it takes as compile-time constants."""
    if lanes not in (1, NUTS_LANES):
        raise ValueError(f"the staged NUTS kernel takes 1 or {NUTS_LANES} lanes a chain, "
                         f"not {lanes}")
    tag, defines = arch_defines(model)
    name = f"{KERNEL}_{tag}_d{int(max_depth)}_l{lanes}_b{NUTS_MIN_BLOCKS}"
    lib = _build.load_library(name, "resident_nuts.cu",
                              tuple(defines) + (f"NUTS_DEPTH={int(max_depth)}",
                                                f"NUTS_LANES={lanes}",
                                                f"NUTS_MIN_BLOCKS={NUTS_MIN_BLOCKS}"))
    lib.resident_nuts_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.POINTER(ResidentHMCParams), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 6)
    lib.resident_nuts_launch.restype = ctypes.c_int
    lib.resident_nuts_error_string.argtypes = [ctypes.c_int]
    lib.resident_nuts_error_string.restype = ctypes.c_char_p
    for fn in (lib.resident_nuts_arch, lib.resident_nuts_resources):
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    lib.resident_nuts_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_int)]
    lib.resident_nuts_max_clusters.restype = ctypes.c_int
    lib.resident_nuts_max_blocks.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
    lib.resident_nuts_max_blocks.restype = ctypes.c_int
    lib.resident_nuts_lanes.argtypes = []
    lib.resident_nuts_lanes.restype = ctypes.c_int
    check_arch(lib.resident_nuts_arch, model, name)
    return lib


def kernel_resources(lib):
    """Registers, local-memory bytes a thread and the most threads a block
    of the loaded staged NUTS kernel."""
    return read_resources(lib.resident_nuts_resources, lib.resident_nuts_error_string, KERNEL)


def max_active_clusters(lib, threads, blocks, n_rows):
    out = ctypes.c_int(0)
    raise_on(lib.resident_nuts_max_clusters(threads, blocks, n_rows, ctypes.byref(out)),
             lib.resident_nuts_error_string, KERNEL)
    return out.value


def group_shape(lib, chain_block, n_rows):
    """``launch_shape`` of a tuned run of this build: the tuning group of
    ``chain_block`` chains (``chain_block`` times the build's lanes threads)
    in one block, or in a cluster the card holds."""
    return launch_shape(kernel_resources(lib),
                        lambda t, b: max_active_clusters(lib, t, b, n_rows),
                        chain_block * lib.resident_nuts_lanes(), grouped=True)


def max_active_blocks(lib, threads, n_rows):
    """Blocks of ``threads`` threads of this build that an SM holds at once,
    for ``n_rows`` staged rows, as the card's occupancy calculator says."""
    out = ctypes.c_int(0)
    raise_on(lib.resident_nuts_max_blocks(threads, n_rows, ctypes.byref(out)),
             lib.resident_nuts_error_string, KERNEL)
    return out.value


def nuts_launch(lib, num_chains, chain_block, n_rows, tuned, sm_count=None):
    """``lane_launch`` of this build for ``num_chains`` chains in groups of
    ``chain_block``: threads, blocks, cluster, the card's occupancy and the
    SMs covered."""
    return lane_launch(num_chains, lib.resident_nuts_lanes(), kernel_resources(lib), chain_block,
                       lambda t: max_active_blocks(lib, t, n_rows),
                       lambda t, b: max_active_clusters(lib, t, b, n_rows), tuned, sm_count)


def _output_buffers(theta0, params):
    """The kernels' outputs, allocated for ``theta0`` [P, C] and ``params``:
    samples [kept, rows, C], final [P, C] and the two [C] sums."""
    P, C = theta0.shape
    if params.num_chains != C:
        raise ValueError("inconsistent shapes")
    rows = P + 2 if params.record_extras else P
    like = dict(dtype=torch.float32, device=theta0.device)
    return (torch.empty((params.kept, rows, C), **like), torch.empty((P, C), **like),
            torch.empty((C,), **like), torch.empty((C,), **like), torch.empty((C,), **like))


def resident_nuts(lib, theta0, x, y, mask, loc, ivar, im, msc, params, threads,
                  cluster_blocks):
    """Launch the kernel: theta0 [P, C] -> (samples [kept, rows, C], final
    [P, C], accept_sums [C], divergent_sums [C], each chain's final step
    [C]), f32 on one CUDA device, on the current stream. ``im`` and ``msc`` [P] are the metric and the
    momentum scale (ones for none); ``params`` a filled
    ``ResidentHMCParams``; rows = P (+2 with record_extras)."""
    for t in (theta0, x, y, mask, loc, ivar, im, msc):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("resident_nuts takes contiguous float32 CUDA tensors")
        if t.device != theta0.device:
            raise ValueError("resident_nuts takes its tensors on one device")
    if params.n_rows != x.shape[0] or loc.numel() != theta0.shape[0]:
        raise ValueError("resident_nuts: inconsistent shapes")
    out = _output_buffers(theta0, params)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_nuts_launch(
        theta0.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(), loc.data_ptr(),
        ivar.data_ptr(), im.data_ptr(), msc.data_ptr(), ctypes.byref(params), threads,
        cluster_blocks, *(t.data_ptr() for t in out), stream)
    raise_on(err, lib.resident_nuts_error_string, f"{KERNEL} launch failed")
    launch_counts[KERNEL] += 1
    return out


def _logaddexp(a, b):
    """The kernels' logaddexp: NaN-propagating max, -inf when both are."""
    m = torch.maximum(a, b)
    r = m + torch.log1p(torch.exp(-torch.abs(a - b)))
    return torch.where(m == -math.inf, m, r)


def _run_nuts_plain(vg, arrays, pr, chain_block, max_depth, theta, im, msc):
    """The NUTS kernels' computation in PyTorch, on [P, C] float32 tensors:
    the outputs of ``resident_nuts`` plus {"step": each chain's final step
    [C]}. ``vg(theta [P, C], *arrays) -> (val [1, C], grad [P, C])``; ``im``
    and ``msc`` [P, 1]; tuning groups of ``chain_block`` chains laid out by
    ``pr.sublanes``."""
    P, C = theta.shape
    D = int(max_depth)
    f32 = dict(dtype=torch.float32, device=theta.device)
    chains = torch.arange(C, dtype=torch.int64, device=theta.device)
    neg_inf = torch.full((C,), -math.inf, **f32)
    falses = torch.zeros(C, dtype=torch.bool, device=theta.device)
    zeros = torch.zeros(C, **f32)

    def mdot(a, b):
        return torch.sum(im * (a * b), dim=0)

    def uturn(dtheta, r_left, r_right):
        return (mdot(dtheta, r_left) < 0.0) | (mdot(dtheta, r_right) < 0.0)

    val, grad = vg(theta, *arrays)
    val = val[0]
    step = torch.full((C,), pr.step, **f32)
    gid = group_index(C, chain_block, pr.sublanes).to(theta.device)
    barh = torch.zeros(C // chain_block, **f32)
    logbare = torch.zeros(C // chain_block, **f32)
    rows = P + 2 if pr.record_extras else P
    samples = torch.empty((pr.kept, rows, C), **f32)
    accepts = torch.zeros(C, **f32)
    divergences = torch.zeros(C, **f32)

    for t in range(pr.num_iters):
        z, dirs, leaf_u, merge_u = kernel_prng.nuts_draws(pr.seed, chains, t, P, D)
        mom = msc * z
        logp0 = val - 0.5 * mdot(mom, mom)
        th_l = th_r = theta
        r_l = r_r = mom
        g_l = g_r = grad
        prop_t, prop_v, prop_g = theta, val, grad
        lse, sum_alpha, num_alpha = zeros, zeros, zeros
        turning = diverging = falses
        for d in range(D):
            active = ~(turning | diverging)
            go_right = dirs[d] < 0.5
            th = torch.where(go_right, th_r, th_l)
            rho = torch.where(go_right, r_r, -r_l)
            g = torch.where(go_right, g_r, g_l)
            # the subtree: 2^d leaves from the chosen end, masked after a stop
            s_lse, s_sum, s_num = neg_inf, zeros, zeros
            s_t, s_v, s_g = th, zeros, g
            s_turn = s_div = falses
            ckpt = [None] * max(D - 1, 1)
            for n in range(1 << d):
                live = ~(s_turn | s_div)
                rho = rho + (0.5 * step) * g
                th = th + step * (im * rho)
                v, g = vg(th, *arrays)
                v = v[0]
                rho = rho + (0.5 * step) * g
                w = (v - 0.5 * mdot(rho, rho)) - logp0
                leaf_div = ~(w > -DIVERGENCE_THRESHOLD)  # NaN too
                alpha = torch.clamp(torch.exp(w), max=1.0)
                alpha = torch.where(torch.isnan(alpha), 0.0, alpha)
                w_eff = torch.where(live, w, -math.inf)
                new_lse = _logaddexp(s_lse, w_eff)
                take = live & (torch.log(leaf_u[d][n]) < w_eff - new_lse)
                s_t = torch.where(take, th, s_t)
                s_v = torch.where(take, v, s_v)
                s_g = torch.where(take, g, s_g)
                s_lse = new_lse
                pc = bin(n).count("1")
                if n % 2 == 0:
                    ckpt[pc] = (th, rho)
                else:
                    trailing = (n ^ (n + 1)).bit_length() - 1
                    found = falses
                    for i in range(pc - trailing, pc):
                        found = found | uturn(th - ckpt[i][0], ckpt[i][1], rho)
                    s_turn = s_turn | (live & found)
                s_div = s_div | (live & leaf_div)
                s_sum = s_sum + torch.where(live, alpha, 0.0)
                s_num = s_num + live.to(torch.float32)
            bad = s_turn | s_div
            sum_alpha = sum_alpha + torch.where(active, s_sum, 0.0)
            num_alpha = num_alpha + torch.where(active, s_num, 0.0)
            accept_log_prob = torch.minimum(s_lse - lse, zeros)
            take = active & ~bad & (torch.log(merge_u[d]) < accept_log_prob)
            prop_t = torch.where(take, s_t, prop_t)
            prop_v = torch.where(take, s_v, prop_v)
            prop_g = torch.where(take, s_g, prop_g)
            ok = active & ~bad
            lse = torch.where(ok, _logaddexp(lse, s_lse), lse)
            okr, okl = ok & go_right, ok & ~go_right
            new_r = torch.where(go_right, rho, -rho)
            th_r = torch.where(okr, th, th_r)
            r_r = torch.where(okr, new_r, r_r)
            g_r = torch.where(okr, g, g_r)
            th_l = torch.where(okl, th, th_l)
            r_l = torch.where(okl, new_r, r_l)
            g_l = torch.where(okl, g, g_l)
            whole_turn = ok & uturn(th_r - th_l, r_l, r_r)
            turning = turning | (active & (bad | whole_turn))
            diverging = diverging | (active & s_div)

        moved = torch.any(prop_t != theta, dim=0)
        theta, val, grad = prop_t, prop_v, prop_g
        accept_stat = sum_alpha / torch.clamp(num_alpha, min=1.0)
        if t >= pr.num_burnin_iters:
            accepts += accept_stat
            divergences += diverging.to(torch.float32)
        if pr.tuned and t < pr.num_burnin_iters:
            stat = group_means(accept_stat, chain_block, pr.sublanes)
            stat = torch.where(torch.isnan(stat), 0.0, stat)
            barh, logbare, new_step = _population_tune(pr, t, barh, logbare, stat)
            step = new_step[gid]

        since = t - pr.num_burnin_iters
        if since >= 0 and since % pr.record_thin == 0 and since // pr.record_thin < pr.kept:
            out = samples[since // pr.record_thin]
            out[:P] = theta
            if pr.record_extras:
                out[P] = val
                out[P + 1] = moved.to(torch.float32)
    return samples, theta, accepts, divergences, {"step": step}


def unpack_nuts_outputs(samples, final, acc, div, P, record_extras):
    """The kernels' [kept, rows, C] samples and [P, C] final state as
    ``(samples [kept, C, P], final [C, P], accept_sums [C], divergent_sums
    [C](, target_val [kept, C], accepted [kept, C] int32))``, views where
    they can be."""
    out = (samples[:, :P, :].transpose(1, 2), final.T, acc, div)
    if record_extras:
        out = out + (samples[:, P, :], samples[:, P + 1, :].to(torch.int32))
    return out


def make_resident_nuts(model, x, y, step, max_depth, num_iters, num_burnin_iters=0,
                       chain_block=256, record_thin=1, tuner=None, stream=None,
                       vmem_limit_bytes=None, mxu_layer0=None, matmul_precision=None,
                       inv_mass=None, record_extras=False, device="cuda"):
    """Build ``fn(seed, theta0s [C, P])`` running the whole fixed-budget NUTS
    loop on staged data (outputs in the module docstring), with ``kept =
    (num_iters - num_burnin_iters) // record_thin``. C must be a multiple of
    ``chain_block``. ``device`` is where the data lives and the tensors
    ``fn`` takes: on a CUDA device every call launches the kernel, on the CPU
    it runs the plain version. ``fn.plain`` runs the plain version on
    ``device``'s tensors, whichever the device."""
    for name, value in (("stream", stream), ("vmem_limit_bytes", vmem_limit_bytes),
                        ("mxu_layer0", mxu_layer0), ("matmul_precision", matmul_precision)):
        if value is not None:
            raise ValueError(f"{name} is a TPU schedule setting with no CUDA counterpart; "
                             "leave it None")
    check_nuts_args(max_depth, tuner)
    D = int(max_depth)
    device = torch.device(device)
    x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature = prepare_data(model, x, y)
    P = model.num_params
    im_np, msc_np = metric_arrays(inv_mass, P)
    params = nuts_params(step, num_iters, num_burnin_iters, record_thin, tuner, record_extras,
                         chain_block, 1, n_rows=x_pad.shape[0], prior_const=prior_const,
                         temperature=temperature)
    arrays = [torch.as_tensor(a, device=device).contiguous()
              for a in (x_pad, y_pad, row_mask, loc, ivar)]
    im, msc = (torch.as_tensor(a, device=device) for a in (im_np, msc_np))
    vg = make_vg(model, x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature)
    lib, shape = None, None
    if device.type == "cuda":
        lib = load_kernel(model, D, chain_lanes(chain_block, tuner is not None))
        if tuner is not None:
            shape = group_shape(lib, chain_block, x_pad.shape[0])
        else:
            shape = launch_shape(kernel_resources(lib), None,
                                 chain_block * lib.resident_nuts_lanes(), grouped=False)

    def setup(seed, theta0s):
        C = theta0s.shape[0]
        if C % chain_block != 0:
            raise ValueError(f"{C} chains not a multiple of chain_block {chain_block}")
        pr = ResidentHMCParams.from_buffer_copy(params)
        pr.seed, pr.num_chains = int(seed), C
        return pr, theta0s.to(torch.float32).T.contiguous()  # [P, C]

    def run_plain(pr, theta_t):
        return _run_nuts_plain(vg, arrays, pr, chain_block, D, theta_t, im[:, None],
                               msc[:, None])

    def fn(seed, theta0s):
        if theta0s.device.type != device.type:
            raise ValueError(f"theta0s on {theta0s.device}, but the function was built for "
                             f"device={device}")
        pr, theta_t = setup(seed, theta0s)
        if lib is None:
            *out, info = run_plain(pr, theta_t)
        else:
            *out, step = resident_nuts(lib, theta_t, *arrays, im, msc, pr, *shape)
            info = {"step": step}
        last_info[KERNEL] = {"accept_sums": out[2], "divergent_sums": out[3], **info}
        return unpack_nuts_outputs(*out, P, record_extras)

    def plain(seed, theta0s):
        """The plain version on ``device``'s tensors: ``fn``'s outputs and
        {"step": each chain's final step [C]}."""
        pr, theta_t = setup(seed, theta0s)
        *out, info = run_plain(pr, theta_t)
        return unpack_nuts_outputs(*out, P, record_extras), info

    fn.plain = plain
    fn.launch_shape = shape
    fn.nuts_launch = lambda C, sm_count=None: (
        None if lib is None else nuts_launch(lib, C, chain_block, x_pad.shape[0],
                                             tuner is not None, sm_count))
    return fn
