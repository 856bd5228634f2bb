"""The whole random-walk MH, MALA or blocked-Gibbs loop of a population of
MLP chains in one kernel, on data of at most 32 rows folded into the code as
constants.

Counterpart of the MH, MALA and Gibbs parts of
``eeyore_tpu/ops/resident_walk_dense.py`` (``_make_resident_dense``,
``make_resident_mh_dense``, ``make_resident_mala_dense``,
``make_resident_gibbs_dense``). The makers return
``fn(seed, theta0s [C, P])`` with the outputs of ``ops/resident_walk.py``;
C must be a multiple of ``chain_block``, itself a multiple of 1024. The
moves and their algebra are those of ``resident_walk`` (with ``0.5 / step``
rounded in float32, as the TPU's dense kernel has it), on the dense body
(``mlp_dense``). On CUDA tensors every call is one launch of
``ops/csrc/resident_walk_dense.cu``, built for the model and its data; on
CPU tensors it runs the plain version ``resident_walk._run_walk_plain`` on
``make_vg_dense``.

The Gibbs move sweeps the sub-blocks of ``resident_walk.gibbs_sub_blocks``
on the incremental body ``mlp_dense.make_incremental_gibbs_dense``: a
proposal recomputes its unit and what lies downstream from a per-chain cache
(in registers on the card, from ``gibbs_dense_source``), on the Gibbs
stream, so a dense and a staged Gibbs run of one seed draw the same numbers.
Its plain version is ``resident_walk._run_gibbs_plain``.

The tempering move (``temperatures``: whole ladders along the ``chain_block
/ 8`` lanes of a sublane row, as the TPU's dense kernel lays its ladders
out) is ``resident_walk``'s, on the dense body; its
plain version is ``resident_walk._run_tempering_plain``. Chain c is rung c %
L, in the sublane-strided chain order too, since C / 8 and the lanes are
multiples of L; on the card a block holds whole ladders.

With a ``tuner`` (an ``HMCDATuner``; ``d`` is the target acceptance, 0.234
for MH and 0.574 for MALA are the classic optima), the proposal scale or
the Langevin step is dual-averaged during burn-in on the mean acceptance
rate of each tuning group, the TPU kernel's sublane-strided grid block of
``chain_block`` chains, and frozen at its averaged value after
(``resident_walk._population_dual_average``). As in the JAX package, the
rates have no NaN guard: one chain's NaN rate stops its group's tuning. On
the card a group larger than a block is a thread-block cluster, as in
``resident_hmc_dense``.
"""

import ctypes

import torch

from eeyore_tpu_torch.ops import _build
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_dense import (
    dense_source,
    gibbs_dense_source,
    make_incremental_gibbs_dense,
)
from eeyore_tpu_torch.ops.resident_hmc import check_arch, raise_on, read_resources, unpack_outputs
from eeyore_tpu_torch.ops.resident_hmc_dense import SUBLANES, dense_plain_vg, launch_shape
from eeyore_tpu_torch.ops.resident_walk import (
    MOVES,
    RESOURCE_CODES,
    ResidentWalkParams,
    _run_gibbs_plain,
    _run_tempering_plain,
    _run_walk_plain,
    _setup,
    check_tensors,
    gibbs_blocks_source,
    gibbs_sub_blocks,
    ladder_rungs,
    ladder_threads,
    set_ladder,
    walk_params,
)

KERNEL = "resident_walk_dense"
GIBBS_KERNEL = "resident_walk_dense_gibbs"  # the Gibbs move of the same library, counted apart
TEMPERING_KERNEL = "resident_walk_dense_tempering"  # the tempering move, counted apart

launch_counts = {KERNEL: 0, GIBBS_KERNEL: 0, TEMPERING_KERNEL: 0}
# What the last call of a Gibbs or tempering function returned as its accept
# counts ({"accept_counts": [C, B]} per sub-block, or [C, 2]: within-rung and
# swap accepts), for callers that go through dispatch.
last_info = {GIBBS_KERNEL: None, TEMPERING_KERNEL: None}


def load_kernel(model, x, y, node_subblock_size=None):
    """Build (at first use) and load the dense walk kernels for ``model``,
    the data ``(x, y)`` and the Gibbs blocking of ``node_subblock_size``,
    which they take as constants."""
    tag, defines = arch_defines(model)
    lib = _build.load_library(
        f"{KERNEL}_{tag}", "resident_walk_dense.cu", defines,
        generated={"dense_body.cuh": dense_source(model, x, y),
                   "dense_gibbs.cuh": gibbs_dense_source(model, x, y),
                   "gibbs_blocks.cuh": gibbs_blocks_source(model, node_subblock_size)})
    lib.resident_walk_dense_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ResidentWalkParams), ctypes.c_int,
         ctypes.c_int] + [ctypes.c_void_p] * 4)
    lib.resident_walk_dense_launch.restype = ctypes.c_int
    lib.resident_walk_dense_error_string.argtypes = [ctypes.c_int]
    lib.resident_walk_dense_error_string.restype = ctypes.c_char_p
    lib.resident_walk_dense_arch.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.resident_walk_dense_arch.restype = ctypes.c_int
    lib.resident_walk_dense_resources.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.resident_walk_dense_resources.restype = ctypes.c_int
    lib.resident_walk_dense_max_clusters.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.resident_walk_dense_max_clusters.restype = ctypes.c_int
    lib.resident_walk_dense_gibbs_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.POINTER(ResidentWalkParams), ctypes.c_int]
        + [ctypes.c_void_p] * 4)
    lib.resident_walk_dense_gibbs_launch.restype = ctypes.c_int
    lib.resident_walk_dense_num_sub_blocks.argtypes = []
    lib.resident_walk_dense_num_sub_blocks.restype = ctypes.c_int
    lib.resident_walk_dense_tempering_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.POINTER(ResidentWalkParams),
                                                   ctypes.c_int] + [ctypes.c_void_p] * 4)
    lib.resident_walk_dense_tempering_launch.restype = ctypes.c_int
    check_arch(lib.resident_walk_dense_arch, model, f"{KERNEL}_{tag}")
    return lib


def kernel_resources(lib, move):
    """``read_resources`` of the loaded ``move`` kernel (a key of
    ``resident_walk.RESOURCE_CODES``)."""
    return read_resources(
        lambda out: lib.resident_walk_dense_resources(RESOURCE_CODES[move], out),
        lib.resident_walk_dense_error_string, KERNEL)


def max_active_clusters(lib, move, threads, blocks):
    out = ctypes.c_int(0)
    raise_on(lib.resident_walk_dense_max_clusters(MOVES[move], threads, blocks,
                                                  ctypes.byref(out)),
             lib.resident_walk_dense_error_string, KERNEL)
    return out.value


def resident_walk_dense(lib, move, theta0, params, threads, cluster_blocks):
    """Launch the ``move`` kernel: theta0 [P, C] -> (samples [kept, rows,
    C], final [P, C], accepts [C]), f32 on one CUDA device, on the current
    stream."""
    P, C = theta0.shape
    if not theta0.is_cuda or theta0.dtype != torch.float32 or not theta0.is_contiguous():
        raise ValueError("resident_walk_dense takes a contiguous float32 CUDA tensor")
    if params.num_chains != C:
        raise ValueError("resident_walk_dense: inconsistent shapes")
    rows = P + 2 if params.record_extras else P
    samples = torch.empty((params.kept, rows, C), dtype=torch.float32, device=theta0.device)
    final = torch.empty((P, C), dtype=torch.float32, device=theta0.device)
    accepts = torch.empty((C,), dtype=torch.float32, device=theta0.device)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_walk_dense_launch(
        MOVES[move], theta0.data_ptr(), ctypes.byref(params), threads, cluster_blocks,
        samples.data_ptr(), final.data_ptr(), accepts.data_ptr(), stream)
    raise_on(err, lib.resident_walk_dense_error_string, f"{KERNEL} launch failed")
    launch_counts[KERNEL] += 1
    return samples, final, accepts


def resident_walk_dense_gibbs(lib, theta0, scales, params, threads):
    """Launch the Gibbs kernel: theta0 [P, C] -> (samples [kept, rows, C],
    final [P, C], accepts [B, C]), f32 on one CUDA device, on the current
    stream; ``scales`` [B] holds each sub-block's proposal scale."""
    P, C = theta0.shape
    check_tensors("resident_walk_dense_gibbs", (theta0, scales))
    B = lib.resident_walk_dense_num_sub_blocks()
    if params.num_chains != C or scales.numel() != B:
        raise ValueError("resident_walk_dense_gibbs: inconsistent shapes")
    rows = P + 2 if params.record_extras else P
    samples = torch.empty((params.kept, rows, C), dtype=torch.float32, device=theta0.device)
    final = torch.empty((P, C), dtype=torch.float32, device=theta0.device)
    accepts = torch.empty((B, C), dtype=torch.float32, device=theta0.device)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_walk_dense_gibbs_launch(
        theta0.data_ptr(), scales.data_ptr(), ctypes.byref(params), threads,
        samples.data_ptr(), final.data_ptr(), accepts.data_ptr(), stream)
    raise_on(err, lib.resident_walk_dense_error_string, f"{GIBBS_KERNEL} launch failed")
    launch_counts[GIBBS_KERNEL] += 1
    return samples, final, accepts


def resident_walk_dense_tempering(lib, move, theta0, temps, params, threads):
    """Launch the tempering kernel with ``move`` ("mh" or "mala") within
    each rung: theta0 [P, C] -> (samples [kept, rows, C], final [P, C],
    accepts [2, C]), f32 on one CUDA device, on the current stream;
    ``temps`` [L] holds each rung's temperature."""
    P, C = theta0.shape
    check_tensors("resident_walk_dense_tempering", (theta0, temps))
    if params.num_chains != C or temps.numel() != params.num_rungs:
        raise ValueError("resident_walk_dense_tempering: inconsistent shapes")
    rows = P + 2 if params.record_extras else P
    samples = torch.empty((params.kept, rows, C), dtype=torch.float32, device=theta0.device)
    final = torch.empty((P, C), dtype=torch.float32, device=theta0.device)
    accepts = torch.empty((2, C), dtype=torch.float32, device=theta0.device)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_walk_dense_tempering_launch(
        int(move == "mala"), theta0.data_ptr(), temps.data_ptr(), ctypes.byref(params), threads,
        samples.data_ptr(), final.data_ptr(), accepts.data_ptr(), stream)
    raise_on(err, lib.resident_walk_dense_error_string, f"{TEMPERING_KERNEL} launch failed")
    launch_counts[TEMPERING_KERNEL] += 1
    return samples, final, accepts


def _check_chain_block(chain_block):
    if chain_block % 1024:
        raise ValueError(f"chain_block must be a multiple of 1024, got {chain_block}")


def _make_resident_dense(model, x, y, num_iters, num_burnin_iters, chain_block, record_thin,
                         move, value, tuner=None, temperatures=None, between_step=None,
                         record_extras=False, device="cuda"):
    """Shared scaffold of the dense MH, MALA and tempering makers:
    ``fn(seed, theta0s [C, P])`` for ``move`` ("mh" with scale ``value``,
    "mala" with step ``value``); with a ladder's ``temperatures`` [L] (whole
    ladders along the ``chain_block / 8`` lanes of a sublane row) and
    ``between_step``, the tempering move with ``move`` within each rung,
    returning counts [C, 2]. ``fn.plain(seed, theta0s)`` runs the plain
    version on the same tensors and also returns its info dict."""
    _check_chain_block(chain_block)
    device = torch.device(device)
    rungs = (None if temperatures is None
             else ladder_rungs(temperatures, chain_block // SUBLANES))
    if rungs is not None and tuner is not None:
        raise ValueError("the tempering move has no tuner")
    P = model.num_params
    vg = dense_plain_vg(model, x, y, with_grad=move == "mala")
    params = walk_params(move, value, num_iters, num_burnin_iters, record_thin, record_extras,
                         chain_block, tuner=tuner, sublanes=SUBLANES)
    if rungs is not None:
        set_ladder(params, rungs, between_step, move, value)
        rungs = torch.as_tensor(rungs, device=device)
    lib, shape = None, None
    if device.type == "cuda":
        lib = load_kernel(model, x, y)
        if rungs is None:
            shape = launch_shape(kernel_resources(lib, move),
                                 lambda t, b: max_active_clusters(lib, move, t, b), chain_block,
                                 grouped=tuner is not None)
        else:
            max_threads = kernel_resources(lib, f"tempering_{move}")["max_threads_per_block"]
            shape = ladder_threads(max_threads, chain_block, len(rungs)), 1
    setup = _setup(params, chain_block, device)

    def run_plain(pr, theta_t):
        if rungs is None:
            return _run_walk_plain(vg, (), pr, move, chain_block, theta_t)
        samples, final, acc, info = _run_tempering_plain(vg, (), pr, move, rungs, theta_t)
        return samples, final, acc.T, info

    def fn(seed, theta0s):
        pr, theta_t = setup(seed, theta0s)
        if lib is None:
            samples, final, acc, _ = run_plain(pr, theta_t)
        elif rungs is None:
            samples, final, acc = resident_walk_dense(lib, move, theta_t, pr, *shape)
        else:
            samples, final, acc = resident_walk_dense_tempering(lib, move, theta_t, rungs, pr,
                                                                shape[0])
            acc = acc.T
        if rungs is not None:
            last_info[TEMPERING_KERNEL] = {"accept_counts": acc}
        return unpack_outputs(samples, final, acc, P, record_extras)

    def plain(seed, theta0s):
        pr, theta_t = setup(seed, theta0s)
        samples, final, acc, info = run_plain(pr, theta_t)
        return unpack_outputs(samples, final, acc, P, record_extras), info

    fn.plain = plain
    fn.launch_shape = shape
    return fn


def make_resident_mh_dense(model, x, y, scale, num_iters, num_burnin_iters=0,
                           chain_block=8192, record_thin=1, tuner=None, record_extras=False,
                           device="cuda"):
    """Whole-loop random-walk MH on the dense body: a symmetric Normal
    proposal, value only; with ``tuner`` the scale is dual-averaged during
    burn-in."""
    return _make_resident_dense(model, x, y, num_iters, num_burnin_iters, chain_block,
                                record_thin, "mh", scale, tuner=tuner,
                                record_extras=record_extras, device=device)


def make_resident_mala_dense(model, x, y, step, num_iters, num_burnin_iters=0,
                             chain_block=8192, record_thin=1, tuner=None, record_extras=False,
                             device="cuda"):
    """Whole-loop MALA on the dense body, with the asymmetric Hastings
    correction; with ``tuner`` the step is dual-averaged during burn-in."""
    return _make_resident_dense(model, x, y, num_iters, num_burnin_iters, chain_block,
                                record_thin, "mala", step, tuner=tuner,
                                record_extras=record_extras, device=device)


def make_resident_gibbs_dense(model, x, y, scales=1.0, node_subblock_size=None, num_iters=1000,
                              num_burnin_iters=0, chain_block=8192, record_thin=1,
                              record_extras=False, device="cuda"):
    """Whole-loop blocked Metropolis-within-Gibbs on the dense incremental
    body (``resident_walk.make_resident_gibbs`` semantics): a sub-block
    proposal perturbs only its coordinates and recomputes only its unit and
    what lies downstream. Returns per-chain per-sub-block accept counts [C,
    B]. C must be a multiple of ``chain_block``, itself a multiple of 1024."""
    _check_chain_block(chain_block)
    device = torch.device(device)
    P = model.num_params
    sub_blocks = gibbs_sub_blocks(model, scales, node_subblock_size)
    params = walk_params("gibbs", 0.0, num_iters, num_burnin_iters, record_thin, record_extras,
                         chain_block, sublanes=SUBLANES)
    scale_t = torch.tensor([scale for _, scale, _ in sub_blocks], dtype=torch.float32,
                           device=device)
    _, init, updates = make_incremental_gibbs_dense(model, x, y)
    lib, shape = None, None
    if device.type == "cuda":
        lib = load_kernel(model, x, y, node_subblock_size)
        shape = launch_shape(kernel_resources(lib, "gibbs"), None, chain_block, grouped=False)
    setup = _setup(params, chain_block, device)

    def fn(seed, theta0s):
        pr, theta_t = setup(seed, theta0s)
        if lib is None:
            samples, final, acc, _ = _run_gibbs_plain(init, updates, sub_blocks, pr, theta_t)
        else:
            samples, final, acc = resident_walk_dense_gibbs(lib, theta_t, scale_t, pr, shape[0])
        last_info[GIBBS_KERNEL] = {"accept_counts": acc.T}
        return unpack_outputs(samples, final, acc.T, P, record_extras)

    def plain(seed, theta0s):
        pr, theta_t = setup(seed, theta0s)
        samples, final, acc, info = _run_gibbs_plain(init, updates, sub_blocks, pr, theta_t)
        return unpack_outputs(samples, final, acc.T, P, record_extras), info

    fn.plain = plain
    fn.launch_shape = shape
    return fn
