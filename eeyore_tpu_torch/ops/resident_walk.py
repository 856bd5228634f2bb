"""The whole random-walk MH or MALA loop of a population of MLP chains in one
kernel, on data staged in shared memory.

Counterpart of the MH and MALA parts of ``eeyore_tpu/ops/resident_walk.py``
(``_make_resident``, ``make_resident_mh``, ``make_resident_mala``).
Each maker returns ``fn(seed, theta0s [C, P]) -> (samples [kept, C, P], final
[C, P], accept_counts [C])``, plus ``target_val [kept, C]`` and ``accepted
[kept, C]`` (int32, exact moved flags) with ``record_extras``; accept counts
are post-burn-in and every ``record_thin``-th post-burn-in state is kept.

- MH: a symmetric Normal walk of fixed ``scale`` on the value-only body (no
  backward pass); ``log_rate = v(prop) - v(theta)``.
- MALA: the Langevin proposal ``theta + (step/2) grad + sqrt(step) z`` with
  the full asymmetric Hastings correction; the two Normal densities'
  constants cancel, so ``log_rate = v(prop) - v(theta) - |theta - prop -
  (step/2) grad(prop)|^2 / (2 step) + |z|^2 / 2``.

Both accept when ``log(u) < log_rate``. On CUDA tensors every call is one
launch of ``ops/csrc/resident_walk.cu``; on CPU tensors it runs the plain
version ``_run_walk_plain`` (shared with ``ops/resident_walk_dense.py``), on
the same Threefry stream (``kernel_prng.walk_draws``: key (seed, chain),
counter (iteration, j)). The blocked Gibbs move (``make_resident_gibbs``,
with ``acc_rows > 1``) and the tempering kernels (``consts``) are not ported
yet; the scaffold takes their arguments and raises.
"""

import ctypes
import math

import numpy as np
import torch

from eeyore_tpu_torch.ops import _build, kernel_prng
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_math import make_vg, prepare_data
from eeyore_tpu_torch.ops.resident_hmc import (
    _population_tune,
    check_arch,
    group_index,
    group_means,
    raise_on,
    read_resources,
    unpack_outputs,
)

KERNEL = "resident_walk"
MOVES = {"mh": 0, "mala": 1}
# Threads per block: chains share nothing, so any multiple of 32 works.
WALK_BLOCK = 256

launch_counts = {KERNEL: 0}


class ResidentWalkParams(ctypes.Structure):
    """The walk kernels' scalar arguments (``ResidentWalkParams`` in
    ``csrc/resident_loop.cuh``), shared with ``resident_walk_dense``."""

    _fields_ = ([(name, ctypes.c_int) for name in (
        "seed", "num_chains", "n_rows", "num_iters", "num_burnin_iters", "record_thin",
        "kept", "record_extras", "tuned", "sublanes", "chain_block")]
        + [(name, ctypes.c_float) for name in (
            "value", "half_step", "sqrt_step", "half_inv_step", "tuner_m", "d", "g", "t0",
            "k", "log_eub", "prior_const", "temperature")])


def walk_params(move, value, num_iters, num_burnin_iters, record_thin, record_extras,
                chain_block, tuner=None, n_rows=0, prior_const=0.0, temperature=1.0,
                sublanes=1):
    """A filled ``ResidentWalkParams`` (without seed and chain count).
    ``value`` is the MH scale or the MALA step; MALA's derived constants are
    rounded as the TPU kernels round them (``0.5 / step`` in float64 on
    staged data, in float32 on dense data)."""
    if move not in MOVES:
        raise ValueError(f"move must be one of {sorted(MOVES)}, got {move!r}")
    f32 = np.float32
    value = float(value)
    params = ResidentWalkParams(
        num_chains=0, n_rows=n_rows, num_iters=num_iters, num_burnin_iters=num_burnin_iters,
        record_thin=record_thin, kept=(num_iters - num_burnin_iters) // record_thin,
        record_extras=int(record_extras), tuned=int(tuner is not None), sublanes=sublanes,
        chain_block=chain_block, value=value, prior_const=prior_const,
        temperature=temperature)
    if move == "mala":
        params.half_step = float(f32(0.5 * value))
        params.sqrt_step = float(f32(math.sqrt(value)))
        params.half_inv_step = float(f32(0.5) / f32(value) if sublanes > 1
                                     else f32(0.5 / value))
    if tuner is not None:
        params.tuner_m = float(f32(math.log(10.0 * value)))
        params.d, params.g, params.t0, params.k = tuner.d, tuner.g, tuner.t0, tuner.k
        params.log_eub = np.inf if tuner.eub is None else float(f32(math.log(tuner.eub)))
    return params


def load_kernel(model):
    """Build (at first use) and load both walk kernels for ``model``'s
    architecture, which they take as compile-time constants."""
    tag, defines = arch_defines(model)
    lib = _build.load_library(f"{KERNEL}_{tag}", "resident_walk.cu", defines)
    lib.resident_walk_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.POINTER(ResidentWalkParams), ctypes.c_int] + [ctypes.c_void_p] * 4)
    lib.resident_walk_launch.restype = ctypes.c_int
    lib.resident_walk_error_string.argtypes = [ctypes.c_int]
    lib.resident_walk_error_string.restype = ctypes.c_char_p
    lib.resident_walk_arch.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.resident_walk_arch.restype = ctypes.c_int
    lib.resident_walk_resources.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.resident_walk_resources.restype = ctypes.c_int
    check_arch(lib.resident_walk_arch, model, f"{KERNEL}_{tag}")
    return lib


def kernel_resources(lib, move):
    """``read_resources`` of the loaded ``move`` kernel."""
    return read_resources(lambda out: lib.resident_walk_resources(MOVES[move], out),
                          lib.resident_walk_error_string, KERNEL)


def resident_walk(lib, move, theta0, x, y, mask, loc, ivar, params, threads):
    """Launch the ``move`` kernel: theta0 [P, C] -> (samples [kept, rows,
    C], final [P, C], accepts [C]), f32 on one CUDA device, on the current
    stream."""
    P, C = theta0.shape
    for t in (theta0, x, y, mask, loc, ivar):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("resident_walk takes contiguous float32 CUDA tensors")
        if t.device != theta0.device:
            raise ValueError("resident_walk takes its tensors on one device")
    if params.num_chains != C or params.n_rows != x.shape[0] or loc.numel() != P:
        raise ValueError("resident_walk: inconsistent shapes")
    rows = P + 2 if params.record_extras else P
    samples = torch.empty((params.kept, rows, C), dtype=torch.float32, device=theta0.device)
    final = torch.empty((P, C), dtype=torch.float32, device=theta0.device)
    accepts = torch.empty((C,), dtype=torch.float32, device=theta0.device)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_walk_launch(
        MOVES[move], theta0.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(),
        loc.data_ptr(), ivar.data_ptr(), ctypes.byref(params), threads, samples.data_ptr(),
        final.data_ptr(), accepts.data_ptr(), stream)
    raise_on(err, lib.resident_walk_error_string, f"{KERNEL} launch failed")
    launch_counts[KERNEL] += 1
    return samples, final, accepts


def _tuner_init(num_groups, value, device):
    """The dense walk tuner's state per group, (barh, logbare, current
    value), as ``_tuner_init`` (resident_walk_dense.py:168-172) starts it."""
    zeros = torch.zeros(num_groups, dtype=torch.float32, device=device)
    return zeros, zeros.clone(), torch.full((num_groups,), value, dtype=torch.float32,
                                            device=device)


def _population_dual_average(pr, extra, mean_rate, t):
    """One update of the dense walk tuner (resident_walk_dense.py:175-193)
    at iteration ``t`` on each group's mean rate: the instantaneous value
    during burn-in, the averaged one from the last burn-in iteration, and
    the state untouched after burn-in."""
    if t >= pr.num_burnin_iters:
        return extra
    barh, logbare, _ = extra
    return _population_tune(pr, t, barh, logbare, mean_rate)


def _run_walk_plain(vg, arrays, pr, move, chain_block, theta):
    """The walk kernels' computation in PyTorch, on [P, C] tensors: same
    inputs and outputs as ``resident_walk``, plus {"evaluations": C * (1 +
    num_iters), "value": each chain's final scale or step [C]}. With
    ``pr.tuned`` the value is dual-averaged on the mean rate of each tuning
    group (``pr.sublanes`` lays them out)."""
    P, C = theta.shape
    f32 = dict(dtype=torch.float32, device=theta.device)
    chains = torch.arange(C, dtype=torch.int64, device=theta.device)
    mala = move == "mala"
    if mala:
        val, grad = vg(theta, *arrays)
    else:
        val = vg(theta, *arrays)
    val = val[0]
    tuned = bool(pr.tuned)
    if tuned:
        gid = group_index(C, chain_block, pr.sublanes).to(theta.device)
        extra = _tuner_init(C // chain_block, pr.value, theta.device)
    rows = P + 2 if pr.record_extras else P
    samples = torch.empty((pr.kept, rows, C), **f32)
    accepts = torch.zeros(C, **f32)

    for t in range(pr.num_iters):
        z, u = kernel_prng.walk_draws(pr.seed, chains, t, P)
        cur = extra[2][gid] if tuned else pr.value
        if mala:
            if tuned:
                half, sq, half_inv = 0.5 * cur, torch.sqrt(cur), 0.5 / cur
            else:
                half, sq, half_inv = pr.half_step, pr.sqrt_step, pr.half_inv_step
            z_sq = torch.sum(z * z, dim=0)
            prop = (theta + half * grad) + sq * z
            v_p, g_p = vg(prop, *arrays)
            v_p = v_p[0]
            d_rev = theta - (prop + half * g_p)
            log_rate = ((v_p - val) - half_inv * torch.sum(d_rev * d_rev, dim=0)) + 0.5 * z_sq
        else:
            prop = theta + cur * z
            v_p = vg(prop, *arrays)[0]
            log_rate = v_p - val
        accept = torch.log(u) < log_rate
        moved = accept & torch.any(prop != theta, dim=0)
        theta = torch.where(accept, prop, theta)
        val = torch.where(accept, v_p, val)
        if mala:
            grad = torch.where(accept, g_p, grad)
        if t >= pr.num_burnin_iters:
            accepts += accept.to(torch.float32)
        if tuned:
            rate = torch.clamp(torch.exp(torch.clamp(log_rate, max=0.0)), max=1.0)
            extra = _population_dual_average(
                pr, extra, group_means(rate, chain_block, pr.sublanes), t)

        since = t - pr.num_burnin_iters
        if since >= 0 and since % pr.record_thin == 0 and since // pr.record_thin < pr.kept:
            out = samples[since // pr.record_thin]
            out[:P] = theta
            if pr.record_extras:
                out[P] = val
                out[P + 1] = moved.to(torch.float32)
    final_value = (extra[2][gid] if tuned
                   else torch.full((C,), pr.value, **f32))
    return samples, theta, accepts, {"evaluations": C * (1 + pr.num_iters),
                                     "value": final_value}


def _check_unported(acc_rows, consts):
    if acc_rows != 1 or consts:
        raise ValueError("acc_rows > 1 (blocked Gibbs) and consts (tempering) wait for "
                         "their kernels; the walk scaffold runs MH and MALA")


def _make_resident(model, x, y, num_iters, num_burnin_iters, chain_block, record_thin, move,
                   value, acc_rows=1, consts=(), record_extras=False, device="cuda"):
    """Shared scaffold of the staged walk makers: ``fn(seed, theta0s [C,
    P])`` for ``move`` ("mh" with scale ``value``, "mala" with step
    ``value``); ``fn.plain(seed, theta0s)`` runs the plain version on the
    same tensors and also returns its info dict."""
    _check_unported(acc_rows, consts)
    device = torch.device(device)
    x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature = prepare_data(model, x, y)
    P = model.num_params
    params = walk_params(move, value, num_iters, num_burnin_iters, record_thin, record_extras,
                         chain_block, n_rows=x_pad.shape[0], prior_const=prior_const,
                         temperature=temperature)
    arrays = [torch.as_tensor(a, device=device).contiguous()
              for a in (x_pad, y_pad, row_mask, loc, ivar)]
    vg = make_vg(model, x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature,
                 with_grad=move == "mala")
    lib, threads = None, None
    if device.type == "cuda":
        lib = load_kernel(model)
        max_threads = kernel_resources(lib, move)["max_threads_per_block"]
        threads = min(WALK_BLOCK, max_threads // 32 * 32)

    def setup(seed, theta0s):
        if theta0s.device.type != device.type:
            raise ValueError(f"theta0s on {theta0s.device}, but the function was built for "
                             f"device={device}")
        C = theta0s.shape[0]
        if C % chain_block != 0:
            raise ValueError(f"{C} chains not a multiple of chain_block {chain_block}")
        pr = ResidentWalkParams.from_buffer_copy(params)
        pr.seed, pr.num_chains = int(seed), C
        return pr, theta0s.to(torch.float32).T.contiguous()  # [P, C]

    def fn(seed, theta0s):
        pr, theta_t = setup(seed, theta0s)
        if lib is None:
            samples, final, acc, _ = _run_walk_plain(vg, arrays, pr, move, chain_block, theta_t)
        else:
            samples, final, acc = resident_walk(lib, move, theta_t, *arrays, pr, threads)
        return unpack_outputs(samples, final, acc, P, record_extras)

    def plain(seed, theta0s):
        pr, theta_t = setup(seed, theta0s)
        samples, final, acc, info = _run_walk_plain(vg, arrays, pr, move, chain_block, theta_t)
        return unpack_outputs(samples, final, acc, P, record_extras), info

    fn.plain = plain
    return fn


def _check_stream(stream):
    if stream is not None:
        raise ValueError("stream is a TPU schedule setting with no CUDA counterpart; "
                         "leave it None")


def make_resident_mala(model, x, y, step, num_iters, num_burnin_iters=0, chain_block=2048,
                       record_thin=1, stream=None, record_extras=False, device="cuda"):
    """Whole-loop MALA: one value-and-gradient evaluation per iteration and
    the asymmetric Hastings correction. C must be a multiple of
    ``chain_block``."""
    _check_stream(stream)
    return _make_resident(model, x, y, num_iters, num_burnin_iters, chain_block, record_thin,
                          "mala", step, record_extras=record_extras, device=device)


def make_resident_mh(model, x, y, scale, num_iters, num_burnin_iters=0, chain_block=2048,
                     record_thin=1, stream=None, record_extras=False, device="cuda"):
    """Whole-loop random-walk MH: a symmetric Normal proposal of ``scale``
    on the value-only body. C must be a multiple of ``chain_block``."""
    _check_stream(stream)
    return _make_resident(model, x, y, num_iters, num_burnin_iters, chain_block, record_thin,
                          "mh", scale, record_extras=record_extras, device=device)
