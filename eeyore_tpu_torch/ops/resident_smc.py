"""Tempered SMC with the mutation pass of every stage in one kernel.

Counterpart of ``eeyore_tpu/ops/resident_smc.py``. SMC's hot path is the
MCMC mutation pass: ``num_mutation_steps`` of MALA or MH per particle and
stage. ``make_resident_smc_mutation`` returns ``fn(seed, beta, theta0s [N,
P]) -> (final [N, P], pot [N], acc_counts [N])`` at the likelihood-tempered
target ``lp + beta * ll`` (the split evaluation ``mlp_math.make_vg(split=
True)``), ``pot`` the final particles' untempered log-likelihood, which the
next stage reweights with, so the runner never evaluates it. On CUDA
tensors an architecture model's pass is one launch of
``csrc/resident_smc.cu`` (the TPU kernel's ``pl.pallas_call`` at
``resident_smc.py:329``); beta is a launch argument, so one build serves
every stage. On CPU tensors it runs the plain version ``_run_mutation_plain``
on the same stream (``kernel_prng.walk_draws``: key (stage seed, particle),
counter (mutation step, j)), which ``fn.plain`` runs on any device. The MH
proposal is ``sqrt(step) z``: in SMC the step is a variance for both moves.
The kernel gives a particle ``SMC_LANES`` lanes of a warp on data of at least
``resident_hmc.LANE_MIN_ROWS`` padded rows, each lane evaluating its own
staged rows (``csrc/lane_eval.cuh::smc_chain``), in blocks of
``SMC_LANE_BLOCK`` threads of which ``SMC_MIN_BLOCKS`` fit an SM; on fewer
rows one thread a particle in blocks of ``SMC_BLOCK`` (``smc_lanes``, a rule
of the rows). Its bound is the 1 + num_mutation_steps evaluations a particle
(operations; the special-function unit on iris), as ``csrc/resident_smc.cu``
sets out.

A ``DistributionModel`` target with ``base_log_pdf`` (the geometric path:
``ll = log target - log base``, ``lp = log base``) runs the same pass on
``csrc/resident_smc_closure.cu``, the counterpart of the TPU kernel's
``kernel_generic`` call (``resident_smc.py:315``), which traces the user's
closure into the Pallas kernel. Here ``closure_trace`` traces the closure's
value and gradient for one particle and generates the kernel's body from
it; its plain version is ``_run_mutation_plain`` on ``make_generic_vg``,
the closure by batched autograd.

``make_resident_smc`` is the whole anneal (the counterpart of
``make_resident_smc``, which JAX runs as one XLA program): the birth, then
per stage the reweighting, the ESS test and systematic resampling
(``samplers/smc.py::reweight_and_resample``), and the mutation pass, with
the particles kept ``[P, N]`` on the device throughout (a resample gathers
along dim 1). A fixed ladder makes no host
synchronisation until the end; an adaptive one (``next_beta``) reads each
stage's beta on the host, to hand it to the kernel. Stage k is seeded with
``seed + 7919 k`` (mod 2^32) as in JAX, the birth and the resampling
uniforms drawn from a generator seeded with ``seed``.

Reproduced JAX choices: the birth potentials come from ``model.log_lik``,
the generic BCE on probabilities, which is -inf where a point saturates on
the wrong side, and later ones from the kernel's log-likelihood on logits
(``resident_smc.py:461-466``); a tempered model raises (``:240-241``).
"""

import ctypes
import math

import numpy as np
import torch

from eeyore_tpu_torch.ops import _build, closure_trace, kernel_prng
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_math import make_vg, prepare_data
from eeyore_tpu_torch.ops.resident_hmc import (
    LANE_MIN_ROWS,
    MAX_BLOCK,
    check_arch,
    raise_on,
    read_resources,
)
from eeyore_tpu_torch.ops.resident_walk import check_tensors
from eeyore_tpu_torch.samplers.smc import (
    log_ess,
    next_beta,
    reweight_and_resample,
    stack_diagnostics,
    warn_truncated,
)

KERNEL = "resident_smc"
CLOSURE_KERNEL = "resident_smc_closure"
MOVES = {"MH": 0, "MALA": 1}
# Threads per block of the build of one thread a particle: particles share
# nothing; 128 lets config 5's 16384 particles fill 128 of the 132 SMs.
SMC_BLOCK = 128
# The build on lanes: lanes of a warp a particle (1, 2, 4 or 8) on data of at
# least LANE_MIN_ROWS padded rows, its threads a block, and the blocks of
# that size an SM must hold at once, which caps the registers (the fastest
# that scripts/lane_sweep.py measured on the H100, PERF.md, section 6).
SMC_LANES = 8
SMC_LANE_BLOCK = 256
SMC_MIN_BLOCKS = 2
LANE_COUNTS = (1, 2, 4, 8)
STAGE_SEED_STRIDE = 7919

launch_counts = {KERNEL: 0, CLOSURE_KERNEL: 0}


class ResidentSMCParams(ctypes.Structure):
    """The kernel's scalar arguments (``ResidentSMCParams`` in
    ``csrc/resident_loop.cuh``)."""

    _fields_ = ([(name, ctypes.c_int) for name in (
        "seed", "num_particles", "n_rows", "num_steps")]
        + [(name, ctypes.c_float) for name in (
            "beta", "sqrt_step", "half_step", "half_inv_step", "prior_const")])


def smc_params(step, num_steps, n_rows=0, prior_const=0.0):
    """A filled ``ResidentSMCParams`` (without seed, particle count and
    beta): the step's derived constants computed in float64 and rounded to
    float32, as JAX divides the Python float."""
    step = float(step)
    f32 = np.float32
    return ResidentSMCParams(
        num_particles=0, n_rows=n_rows, num_steps=int(num_steps),
        sqrt_step=float(f32(math.sqrt(step))), half_step=float(f32(0.5 * step)),
        half_inv_step=float(f32(0.5 / step)), prior_const=prior_const)


def stage_seed(seed, stage):
    """The seed of stage ``stage`` (1-based): seed + 7919 stage mod 2^32, as
    the int32 the kernel takes (it reads the bits as unsigned)."""
    s = (int(seed) + STAGE_SEED_STRIDE * int(stage)) & kernel_prng.MASK32
    return s - (1 << 32) if s >= 1 << 31 else s


def check_lanes(lanes):
    """``lanes`` as an int, if a particle of the mutation kernel takes that
    many lanes (1, 2, 4 or 8): else ValueError."""
    if int(lanes) not in LANE_COUNTS:
        raise ValueError(f"a particle of the SMC mutation kernel takes 1, 2, 4 or 8 lanes, "
                         f"not {lanes}")
    return int(lanes)


def smc_lanes(n_rows):
    """Lanes a particle of the mutation kernel on ``n_rows`` staged (padded)
    rows: ``SMC_LANES``, or 1 (one thread a particle) on fewer than
    ``LANE_MIN_ROWS`` rows, where a lane would get next to no rows."""
    return check_lanes(SMC_LANES) if n_rows >= LANE_MIN_ROWS else 1


def library_spec(model, lanes=None):
    """(name, source, defines) of the mutation kernel's build for
    ``model``'s architecture on ``lanes`` lanes a particle (``SMC_LANES`` by
    default) at ``SMC_MIN_BLOCKS``: the arguments of ``_build.load_library``."""
    lanes = check_lanes(SMC_LANES if lanes is None else lanes)
    tag, defines = arch_defines(model)
    return (f"{KERNEL}_{tag}_l{lanes}_b{SMC_MIN_BLOCKS}", "resident_smc.cu",
            tuple(defines) + (f"SMC_LANES={lanes}", f"SMC_MIN_BLOCKS={SMC_MIN_BLOCKS}"))


def load_kernel(model, lanes=None):
    """Build (at first use) and load the mutation kernel for ``model``'s
    architecture and ``lanes`` lanes a particle (``library_spec``), which
    it takes as compile-time constants."""
    name, source, defines = library_spec(model, lanes)
    lib = _build.load_library(name, source, defines)
    lib.resident_smc_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.POINTER(ResidentSMCParams), ctypes.c_int] + [ctypes.c_void_p] * 4)
    lib.resident_smc_launch.restype = ctypes.c_int
    lib.resident_smc_error_string.argtypes = [ctypes.c_int]
    lib.resident_smc_error_string.restype = ctypes.c_char_p
    lib.resident_smc_arch.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.resident_smc_arch.restype = ctypes.c_int
    lib.resident_smc_resources.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.resident_smc_resources.restype = ctypes.c_int
    lib.resident_smc_lanes.argtypes = []
    lib.resident_smc_lanes.restype = ctypes.c_int
    lib.resident_smc_max_blocks.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.resident_smc_max_blocks.restype = ctypes.c_int
    check_arch(lib.resident_smc_arch, model, name)
    return lib


def smc_threads(lanes, max_threads, num_particles):
    """Threads a block of a mutation launch: on one thread a particle
    ``SMC_BLOCK`` (a ragged last block is fine); on lanes the largest
    multiple of 32 up to ``SMC_LANE_BLOCK`` that the build allows and that
    divides the particles' threads, so that the launch covers them exactly."""
    top = min(max_threads, MAX_BLOCK) // 32 * 32
    if lanes == 1:
        return min(SMC_BLOCK, top)
    for threads in range(min(SMC_LANE_BLOCK, top), 31, -32):
        if (num_particles * lanes) % threads == 0:
            return threads
    raise ValueError(f"{num_particles} particles on {lanes} lanes fill no block of a multiple "
                     f"of 32 threads")


def smc_launch(lib, mutation, num_particles, n_rows, sm_count=None):
    """The mutation launch of the loaded build for ``num_particles``
    particles on ``n_rows`` staged rows: lanes, threads, blocks, the blocks
    an SM holds (the card's occupancy calculator on the build) and, with the
    card's ``sm_count``, the waves and the SMs the first wave covers."""
    lanes = lib.resident_smc_lanes()
    threads = smc_threads(lanes, kernel_resources(lib, mutation)["max_threads_per_block"],
                          num_particles)
    out = ctypes.c_int(0)
    raise_on(lib.resident_smc_max_blocks(MOVES[mutation], threads, n_rows, ctypes.byref(out)),
             lib.resident_smc_error_string, KERNEL)
    blocks = -(-num_particles * lanes // threads)
    per_sm = out.value
    launch = {"lanes": lanes, "threads": threads, "blocks": blocks, "blocks_per_sm": per_sm,
              "waves": None, "sms_covered": None}
    if sm_count is not None and per_sm:
        launch.update(waves=-(-blocks // (per_sm * sm_count)),
                      sms_covered=min(sm_count, -(-blocks // per_sm)))
    return launch


def closure_programs(model, x, y, base_log_pdf, device="cpu"):
    """(value-only, value-and-gradient) ``closure_trace.Program`` of one
    particle's split evaluation of a ``DistributionModel`` target on the
    geometric path, traced on ``device``."""
    ll_fn, lp_fn = _geometric(model, x, y, base_log_pdf, device)
    return tuple(closure_trace.trace_split(ll_fn, lp_fn, model.num_params, with_grad, device)
                 for with_grad in (False, True))


def _closure_dims(P):
    """(in, out) of the one-layer net whose parameter count, in * out = P,
    the closure kernel's build gives resident_loop.cuh (widths <= 255)."""
    for out in range(1, 256):
        if P % out == 0 and P // out <= 255:
            return P // out, out
    raise ValueError(f"the closure kernel takes at most 255 * 255 parameters, got {P}")


def load_closure_kernel(programs):
    """Build (at first use) and load the closure kernel for the
    ``closure_programs`` of one target, whose body it takes as code."""
    prog_v, prog_vg = programs
    P = prog_v.num_params
    d_in, d_out = _closure_dims(P)
    defines = ("FMV_NUM_LAYERS=1", f"FMV_DIMS={d_in | d_out << 8:#x}", "FMV_BIAS=0", "FMV_CE=0")
    lib = _build.load_library(f"{CLOSURE_KERNEL}_p{P}", "resident_smc_closure.cu", defines,
                              generated={"closure_body.cuh":
                                         closure_trace.cuda_source(prog_v, prog_vg)})
    lib.resident_smc_closure_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ResidentSMCParams), ctypes.c_int]
        + [ctypes.c_void_p] * 4)
    lib.resident_smc_closure_launch.restype = ctypes.c_int
    lib.resident_smc_closure_error_string.argtypes = [ctypes.c_int]
    lib.resident_smc_closure_error_string.restype = ctypes.c_char_p
    lib.resident_smc_closure_arch.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.resident_smc_closure_arch.restype = ctypes.c_int
    lib.resident_smc_closure_resources.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.resident_smc_closure_resources.restype = ctypes.c_int
    arch = (ctypes.c_int * 2)()
    lib.resident_smc_closure_arch(arch)
    if list(arch) != [P, MAX_BLOCK]:
        raise RuntimeError(f"{CLOSURE_KERNEL}: library built for {list(arch)}, the target needs "
                           f"{[P, MAX_BLOCK]}")
    return lib


def kernel_resources(lib, mutation, name=KERNEL):
    """``read_resources`` of the loaded kernel ``name`` (``KERNEL`` or
    ``CLOSURE_KERNEL``) of ``mutation`` ("MH" or "MALA")."""
    return read_resources(lambda out: getattr(lib, f"{name}_resources")(MOVES[mutation], out),
                          getattr(lib, f"{name}_error_string"), name)


def resident_smc(lib, mutation, theta0, x, y, mask, loc, ivar, params, threads):
    """Launch the kernel: theta0 [P, N] -> (final [P, N], pot [N], accept
    counts [N]), f32 on one CUDA device, on the current stream."""
    P, N = theta0.shape
    check_tensors("resident_smc", (theta0, x, y, mask, loc, ivar))
    if params.num_particles != N or params.n_rows != x.shape[0] or loc.numel() != P:
        raise ValueError("resident_smc: inconsistent shapes")
    final = torch.empty((P, N), dtype=torch.float32, device=theta0.device)
    pot = torch.empty((N,), dtype=torch.float32, device=theta0.device)
    accepts = torch.empty((N,), dtype=torch.float32, device=theta0.device)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_smc_launch(
        MOVES[mutation], theta0.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(),
        loc.data_ptr(), ivar.data_ptr(), ctypes.byref(params), threads, final.data_ptr(),
        pot.data_ptr(), accepts.data_ptr(), stream)
    raise_on(err, lib.resident_smc_error_string, f"{KERNEL} launch failed")
    launch_counts[KERNEL] += 1
    return final, pot, accepts


def resident_smc_closure(lib, mutation, theta0, params, threads):
    """Launch the closure kernel: theta0 [P, N] -> (final [P, N], pot [N],
    accept counts [N]), f32 on one CUDA device, on the current stream."""
    P, N = theta0.shape
    check_tensors(CLOSURE_KERNEL, (theta0,))
    if params.num_particles != N:
        raise ValueError(f"{CLOSURE_KERNEL}: inconsistent shapes")
    final = torch.empty((P, N), dtype=torch.float32, device=theta0.device)
    pot = torch.empty((N,), dtype=torch.float32, device=theta0.device)
    accepts = torch.empty((N,), dtype=torch.float32, device=theta0.device)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_smc_closure_launch(
        MOVES[mutation], theta0.data_ptr(), ctypes.byref(params), threads, final.data_ptr(),
        pot.data_ptr(), accepts.data_ptr(), stream)
    raise_on(err, lib.resident_smc_closure_error_string, f"{CLOSURE_KERNEL} launch failed")
    launch_counts[CLOSURE_KERNEL] += 1
    return final, pot, accepts


def _run_mutation_plain(vg, pr, mutation, theta):
    """The kernel's computation in PyTorch on theta [P, N]: ``vg(theta) ->
    (ll [1, N], lp [1, N][, gll [P, N], glp [P, N]])`` is the split
    evaluation, ``pr`` a filled ``ResidentSMCParams``. Returns (final [P, N],
    pot [N], accept counts [N], {"evaluations": N * (1 + num_steps)})."""
    P, N = theta.shape
    mala = mutation == "MALA"
    beta = pr.beta
    particles = torch.arange(N, dtype=torch.int64, device=theta.device)

    def evaluate(th):
        out = vg(th)
        ll, lp = out[0][0], out[1][0]
        return lp + beta * ll, ll, (out[3] + beta * out[2]) if mala else None

    val, ll, grad = evaluate(theta)
    accepts = torch.zeros(N, dtype=torch.float32, device=theta.device)
    for s in range(pr.num_steps):
        z, u = kernel_prng.walk_draws(pr.seed, particles, s, P)
        z = z.to(theta.dtype)
        if mala:
            z_sq = torch.sum(z * z, dim=0)
            prop = (theta + pr.half_step * grad) + pr.sqrt_step * z
            v_p, ll_p, g_p = evaluate(prop)
            d_rev = theta - (prop + pr.half_step * g_p)
            log_rate = ((v_p - val) - pr.half_inv_step * torch.sum(d_rev * d_rev, dim=0)) \
                + 0.5 * z_sq
        else:
            prop = theta + pr.sqrt_step * z
            v_p, ll_p, _ = evaluate(prop)
            log_rate = v_p - val
        accept = torch.log(u) < log_rate
        theta = torch.where(accept, prop, theta)
        val = torch.where(accept, v_p, val)
        ll = torch.where(accept, ll_p, ll)
        if mala:
            grad = torch.where(accept, g_p, grad)
        accepts += accept.to(torch.float32)
    return theta, ll, accepts, {"evaluations": N * (1 + pr.num_steps)}


def _geometric(model, x, y, base_log_pdf, device):
    """(ll_fn, lp_fn) of a non-architecture target on the geometric path:
    ``ll = log target - log base``, ``lp = log base``, with the data on
    ``device`` as float32, as JAX's."""
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    y = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=device)

    def ll_fn(th):
        return model.log_target(th, x, y) - base_log_pdf(th)

    return ll_fn, base_log_pdf


def make_generic_vg(model, x, y, base_log_pdf, with_grad, device="cuda"):
    """``vg(theta [P, N]) -> (ll [1, N], lp [1, N][, gll [P, N], glp [P,
    N]])`` for a non-architecture target on the geometric path (``_geometric``),
    by batched autograd over the particles (the counterpart of
    ``resident_smc.py:93-119``, which vmaps ``jax.value_and_grad`` over the
    lanes): the plain version of the closure kernel's evaluation."""
    ll_fn, _ = _geometric(model, x, y, base_log_pdf, device)

    def value_and_grad(fn, th):
        with torch.enable_grad():
            th = th.detach().requires_grad_(True)
            val = fn(th)
            (grad,) = torch.autograd.grad(val.sum(), th)
        return val.detach(), grad

    def vg(theta):
        th = theta.T  # [N, P]: the closures take particles on the leading dimension
        if with_grad:
            ll, gll = value_and_grad(ll_fn, th)
            lp, glp = value_and_grad(base_log_pdf, th)
            return ll[None], lp[None], gll.T, glp.T
        return ll_fn(th)[None], base_log_pdf(th)[None]

    return vg


def make_resident_smc_mutation(model, x, y, step, num_mutation_steps, chain_block=4096,
                               mutation="MALA", base_log_pdf=None, device="cuda"):
    """Build ``fn(seed, beta, theta0s [N, P]) -> (final [N, P], pot [N],
    acc_counts [N])``: ``num_mutation_steps`` MALA or MH moves of every
    particle at the target prior * lik^beta, ``pot`` the final untempered
    log-likelihood. N must be a multiple of ``chain_block`` (the TPU
    kernel's grid block; the CUDA kernel's blocks are ``smc_threads``).
    ``fn.transposed(seed, beta, theta [P, N])`` takes and returns the
    particles ``[P, N]`` (the runner's layout); ``fn.plain(seed, beta,
    theta0s)`` runs the plain version on any device and also returns its
    info dict; ``fn.smc_launch(N, sm_count)`` reports the launch
    (``smc_launch``) of the MLP kernel.

    ``base_log_pdf``: for a ``DistributionModel`` target, the base of the
    geometric path; CUDA tensors then launch the closure kernel, built from
    the closure (``closure_programs``; an operation it cannot lower raises),
    and the plain version runs ``make_generic_vg``. ``fn.eval_work`` is the
    (f32 operations, special-function operations) of one evaluation of the
    closure kernel's body, None otherwise."""
    if mutation not in MOVES:
        raise ValueError(f"unsupported mutation {mutation!r} (MALA or MH)")
    device = torch.device(device)
    mala = mutation == "MALA"
    closure = base_log_pdf is not None
    lib, eval_work = None, None
    if closure:
        vg = make_generic_vg(model, x, y, base_log_pdf, mala, device)
        params = smc_params(step, num_mutation_steps)
        if device.type == "cuda":
            programs = closure_programs(model, x, y, base_log_pdf, device)
            eval_work = closure_trace.work(programs[1 if mala else 0])
            lib = load_closure_kernel(programs)
    else:
        x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature = prepare_data(model, x, y)
        if temperature != 1.0:
            raise ValueError("pass an untempered model; SMC applies the beta ladder")
        params = smc_params(step, num_mutation_steps, n_rows=x_pad.shape[0],
                            prior_const=prior_const)
        arrays = [torch.as_tensor(a, device=device).contiguous()
                  for a in (x_pad, y_pad, row_mask, loc, ivar)]
        split_vg = make_vg(model, x_pad, y_pad, row_mask, loc, ivar, prior_const, 1.0,
                           with_grad=mala, split=True)

        def vg(theta):
            return split_vg(theta, *arrays)

        if device.type == "cuda":
            lib = load_kernel(model, smc_lanes(x_pad.shape[0]))
    max_threads, lanes = None, 1
    if lib is not None:
        max_threads = kernel_resources(lib, mutation, CLOSURE_KERNEL if closure else KERNEL)[
            "max_threads_per_block"]
        lanes = 1 if closure else lib.resident_smc_lanes()

    def launch_threads(N):
        return smc_threads(lanes, max_threads, N)

    def setup(seed, beta, theta):
        if theta.device.type != device.type:
            raise ValueError(f"particles on {theta.device}, but the function was built for "
                             f"device={device}")
        N = theta.shape[1]
        if N % chain_block != 0:
            raise ValueError(f"{N} particles not a multiple of chain_block {chain_block}")
        pr = ResidentSMCParams.from_buffer_copy(params)
        pr.seed, pr.num_particles, pr.beta = int(seed), N, float(np.float32(beta))
        return pr, theta.to(torch.float32).contiguous()

    def transposed(seed, beta, theta):
        pr, theta = setup(seed, beta, theta)
        if lib is None:
            return _run_mutation_plain(vg, pr, mutation, theta)[:3]
        threads = launch_threads(pr.num_particles)
        if closure:
            return resident_smc_closure(lib, mutation, theta, pr, threads)
        return resident_smc(lib, mutation, theta, *arrays, pr, threads)

    def fn(seed, beta, theta0s):
        final, pot, acc = transposed(seed, beta, theta0s.T)
        return final.T, pot, acc

    def plain(seed, beta, theta0s):
        pr, theta = setup(seed, beta, theta0s.T)
        final, pot, acc, info = _run_mutation_plain(vg, pr, mutation, theta)
        return (final.T, pot, acc), info

    fn.transposed = transposed
    fn.plain = plain
    fn.launch_threads = None if lib is None else launch_threads(chain_block)
    fn.smc_launch = lambda N, sm_count=None: (
        None if lib is None or closure else smc_launch(lib, mutation, N, x_pad.shape[0],
                                                       sm_count))
    fn.eval_work = eval_work
    return fn


def make_resident_smc(model, x, y, num_particles, betas=None, num_mutation_steps=2,
                      mutation="MALA", mutation_step=0.1, ess_threshold=0.5, chain_block=4096,
                      adaptive_target_ess=0.5, max_stages=50, init_sampler=None,
                      base_log_pdf=None, device="cuda"):
    """Build ``runner(seed) -> (particles [N, P], log_weights [N],
    diagnostics)``: tempered SMC with ``samplers/smc.py``'s semantics (the
    prior * lik^beta path, ESS-triggered systematic resampling, evidence
    accumulation), every mutation pass on ``make_resident_smc_mutation``.
    Diagnostics carry the per-stage "beta", "ess", "resampled",
    "mutation_acceptance" (the mean accept count over the steps) and
    "unique_frac" as CPU tensors, "log_evidence" and "final_weight_ess".

    ``betas="adaptive"`` chooses each next temperature by ESS bisection
    (``next_beta``), resampling whenever its constraint binds, for at most
    ``max_stages`` stages; diagnostics gain "num_stages" and "final_beta",
    and a run that stops short of beta = 1 warns.

    ``init_sampler(generator, n)`` / ``base_log_pdf``: for a
    ``DistributionModel`` target, the birth from the base and its
    log-density (the mutation pass on the closure kernel)."""
    adaptive = isinstance(betas, str) and betas == "adaptive"
    if not adaptive:
        if betas is None:
            betas = [(i / 10) ** 4 for i in range(0, 11)]
        betas = np.asarray(betas, dtype=np.float32)
    n = int(num_particles)
    closure = base_log_pdf is not None
    if closure and init_sampler is None:
        raise ValueError("non-Bayesian targets need init_sampler(generator, n) alongside "
                         "base_log_pdf")
    device = torch.device(device)
    mut = make_resident_smc_mutation(model, x, y, mutation_step, num_mutation_steps,
                                     chain_block=chain_block, mutation=mutation,
                                     base_log_pdf=base_log_pdf, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    xt = torch.as_tensor(np.asarray(x), **f32)
    yt = torch.as_tensor(np.asarray(y), **f32)
    betas_t = None if adaptive else torch.as_tensor(betas, device=device)

    def stage(gen, carry, beta_prev, beta, beta_host, seed, force_resample=None):
        particles, pots, log_w, log_z = carry
        log_w, log_z, ess, do_resample, idx, unique_frac = reweight_and_resample(
            log_w, log_z, pots, beta_prev, beta, ess_threshold, gen,
            force_resample=force_resample)
        particles = torch.where(do_resample, particles[:, idx], particles)
        # the pass returns the potentials of the particles it is given, so
        # those of the resampled cloud need no gather (JAX's at :421 is
        # overwritten at :429)
        particles, pots, acc = mut.transposed(seed, beta_host, particles)
        out = {"beta": beta, "ess": ess, "resampled": do_resample,
               "mutation_acceptance": torch.mean(acc) / num_mutation_steps,
               "unique_frac": unique_frac}
        return (particles, pots, log_w, log_z), out

    def runner(seed):
        gen = torch.Generator(device=device).manual_seed(int(seed))
        if closure:
            particles = torch.as_tensor(init_sampler(gen, n), **f32)
            pots = model.log_target(particles, xt, yt) - base_log_pdf(particles)
        else:
            particles = model.prior.sample(gen, (n,)).to(**f32)
            pots = model.log_lik(particles, xt, yt)
        carry = (particles.T.contiguous(), pots.to(**f32), torch.zeros(n, **f32),
                 torch.zeros((), **f32))
        outs = []
        if not adaptive:
            for k in range(1, len(betas)):
                carry, out = stage(gen, carry, betas_t[k - 1], betas_t[k], float(betas[k]),
                                   stage_seed(seed, k))
                outs.append(out)
        else:
            beta, beta_host = torch.zeros((), **f32), 0.0
            while beta_host < 1.0 and len(outs) < max_stages:
                new_beta = next_beta(carry[2], carry[1], beta, adaptive_target_ess)
                beta_host = float(new_beta)  # the stage's one host synchronisation
                carry, out = stage(gen, carry, beta, new_beta, beta_host,
                                   stage_seed(seed, len(outs) + 1),
                                   force_resample=new_beta < 1.0)
                beta = new_beta
                outs.append(out)
        particles, _, log_w, log_z = carry
        diagnostics = stack_diagnostics(outs)
        if adaptive:
            diagnostics["num_stages"] = len(outs)
            diagnostics["final_beta"] = beta_host
            warn_truncated(len(outs), max_stages, beta_host)
        diagnostics["log_evidence"] = float(log_z)
        diagnostics["final_weight_ess"] = float(torch.exp(log_ess(log_w)))
        return particles.T.contiguous(), log_w, diagnostics

    return runner
