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

On the card the MH, MALA and ladder moves give a chain the lanes of a warp
that ``WALK_DENSE_LANES`` sets for each move, never more than the data has
rows (``dense_lanes``): lane l evaluates the generated lane body
(``mlp_dense.dense_lane_source``) on rows l, l + lanes, ..., whose inputs and
labels it holds in registers, and the lanes sum the value and reduce-scatter
the gradient (``csrc/lane_eval.cuh``); a setting of 1 is one thread a chain.
A tuning group keeps its ``chain_block`` chains in a block or a cluster of
at most 16 blocks of ``WALK_DENSE_BLOCK`` threads; a group that none holds
on lanes, a ladder too long for such a block or in chain blocks large
enough to fill the card on one thread a chain, and data of one row take
the build of one thread a chain (``walk_dense_lanes``,
``dense_tempering_lanes``: rules decided before the launch). The Gibbs
move runs one thread a chain.
"""

import ctypes

import torch

from eeyore_tpu_torch.ops import _build
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_dense import (
    dense_lane_source,
    dense_source,
    gibbs_dense_source,
    make_incremental_gibbs_dense,
    prepare_dense,
)
from eeyore_tpu_torch.ops.resident_hmc import (
    MAX_CLUSTER,
    check_arch,
    raise_on,
    read_resources,
    unpack_outputs,
)
from eeyore_tpu_torch.ops.resident_hmc_dense import (
    SUBLANES,
    dense_plain_vg,
    lane_launch,
    launch_shape,
)
from eeyore_tpu_torch.ops.resident_walk import (
    MOVES,
    RESOURCE_CODES,
    ResidentWalkParams,
    _ladder_sizes,
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

# Lanes of a warp a chain of the MH, MALA and ladder moves (1, 2, 4, 8, 16 or
# 32; on data of fewer rows, the largest power of two not above the rows),
# the most threads a block of a lane build may have, and the blocks of that
# size an SM must hold at once, which caps the registers: the fastest that
# scripts/lane_sweep.py measured on the H100 (PERF.md, section 6) for
# BASELINE.md config 1 (MH on XOR, where one thread a chain, whose six
# Threefry words and four rows run side by side, issues fewer instructions
# than any split), config 2 (MALA) and the XOR ladder at its entry point's
# one chain block (1024 chains, which one thread a chain puts on 32 SMs).
WALK_DENSE_LANES = {"mh": 1, "mala": 2, "ladder": 4}
WALK_DENSE_BLOCK = 256
WALK_DENSE_MIN_BLOCKS = 2
LANE_COUNTS = (1, 2, 4, 8, 16, 32)

launch_counts = {KERNEL: 0, GIBBS_KERNEL: 0, TEMPERING_KERNEL: 0}
# What the last call of a Gibbs or tempering function returned as its accept
# counts ({"accept_counts": [C, B]} per sub-block, or [C, 2]: within-rung and
# swap accepts), for callers that go through dispatch.
last_info = {GIBBS_KERNEL: None, TEMPERING_KERNEL: None}


def check_dense_lanes(lanes, n_rows):
    """``lanes`` as an int, if a chain of the dense MH, MALA and ladder
    moves can take that many lanes on data of ``n_rows`` rows (a divisor of
    a warp, and no more lanes than rows): else ValueError."""
    if int(lanes) not in LANE_COUNTS or int(lanes) > n_rows:
        raise ValueError(f"a chain of the dense walk takes 1, 2, 4, 8, 16 or 32 lanes and no "
                         f"more than the {n_rows} data rows, not {lanes}")
    return int(lanes)


def dense_lanes(n_rows, move):
    """Lanes a chain of the dense ``move`` ("mh", "mala" or "ladder") on
    ``n_rows`` data rows: ``WALK_DENSE_LANES[move]``, or on fewer rows the
    largest power of two not above them, so that no lane goes without a
    row."""
    lanes = check_dense_lanes(WALK_DENSE_LANES[move], LANE_COUNTS[-1])
    while lanes > max(int(n_rows), 1):
        lanes //= 2
    return check_dense_lanes(lanes, n_rows)


def walk_dense_lanes(n_rows, chain_block, tuned, move):
    """Lanes a chain of a dense MH or MALA run (``move``): ``dense_lanes``,
    or 1 (one thread a chain) for a tuning group of ``chain_block`` chains
    that no cluster of ``MAX_CLUSTER`` blocks of ``WALK_DENSE_BLOCK`` threads
    holds on those lanes, so that the group stays JAX's."""
    lanes = dense_lanes(n_rows, move)
    if lanes > 1 and tuned and chain_block * lanes > MAX_CLUSTER * WALK_DENSE_BLOCK:
        return 1
    return lanes


def dense_tempering_lanes(n_rows, num_rungs, chain_block, sm_count=None):
    """Lanes a chain of a dense ladder of ``num_rungs`` rungs in chain
    blocks of ``chain_block``: ``dense_lanes``, where a block of at most
    ``WALK_DENSE_BLOCK`` threads holds whole ladders of consecutive chains
    along a sublane row and one chain block on one thread a chain would give
    fewer warps than the card's ``sm_count`` SMs (the entry point's launch:
    ``PowerPosteriorSampler.run`` runs one chain block), else 1 (one thread
    a chain, blocks of up to 1024 threads): on XOR one thread a chain ran
    the ladder faster where its warps cover the card (PERF.md, section 6)."""
    lanes = dense_lanes(n_rows, "ladder")
    if sm_count is not None and chain_block // 32 >= sm_count:
        return 1
    if lanes > 1 and not _ladder_sizes(WALK_DENSE_BLOCK, chain_block, num_rungs, lanes,
                                       SUBLANES):
        return 1
    return lanes


def library_spec(model, x, y, node_subblock_size=None, lanes=None):
    """(name, source, defines, generated headers) of the dense walk build
    for ``model``, the data ``(x, y)``, the Gibbs blocking of
    ``node_subblock_size`` and ``lanes`` lanes a chain of the MH, MALA and
    ladder moves (by default the MH move's ``dense_lanes``: the Gibbs move
    runs one thread a chain in every build) at ``WALK_DENSE_MIN_BLOCKS``:
    the arguments of ``_build.load_library``."""
    n_rows = prepare_dense(model, x, y)[0].shape[0]
    lanes = check_dense_lanes(dense_lanes(n_rows, "mh") if lanes is None else lanes, n_rows)
    tag, defines = arch_defines(model)
    generated = {"dense_body.cuh": dense_source(model, x, y),
                 "gibbs_blocks.cuh": gibbs_blocks_source(model, node_subblock_size)}
    if hasattr(model, "num_par_blocks"):  # the Gibbs move's body (gibbs_blocks_source)
        generated["dense_gibbs.cuh"] = gibbs_dense_source(model, x, y)
    if lanes > 1:
        generated["dense_lanes.cuh"] = dense_lane_source(model, x, y, lanes)
    return (f"{KERNEL}_{tag}_l{lanes}_b{WALK_DENSE_MIN_BLOCKS}", "resident_walk_dense.cu",
            tuple(defines) + (f"WALK_DENSE_LANES={lanes}",
                              f"WALK_DENSE_MIN_BLOCKS={WALK_DENSE_MIN_BLOCKS}"), generated)


def load_kernel(model, x, y, node_subblock_size=None, lanes=None):
    """Build (at first use) and load the dense walk kernels for ``model``,
    the data ``(x, y)`` and the Gibbs blocking of ``node_subblock_size``,
    which they take as constants, the MH, MALA and ladder moves on
    ``lanes`` lanes a chain (``library_spec``)."""
    spec = library_spec(model, x, y, node_subblock_size, lanes)
    lib = _build.load_library(*spec)
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
    lib.resident_walk_dense_lanes.argtypes = []
    lib.resident_walk_dense_lanes.restype = ctypes.c_int
    lib.resident_walk_dense_max_blocks.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.resident_walk_dense_max_blocks.restype = ctypes.c_int
    check_arch(lib.resident_walk_dense_arch, model, spec[0])
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


def max_active_blocks(lib, move, threads, extras=False):
    """Blocks of ``threads`` threads of the loaded ``move`` kernel (a key of
    ``resident_walk.RESOURCE_CODES`` but "gibbs") an SM holds at once."""
    out = ctypes.c_int(0)
    raise_on(lib.resident_walk_dense_max_blocks(RESOURCE_CODES[move], threads, int(extras),
                                                ctypes.byref(out)),
             lib.resident_walk_dense_error_string, KERNEL)
    return out.value


def consecutive(lanes, chain_block):
    """``fits(threads)`` of a dense lane launch: a block's chains divide the
    ``chain_block / 8`` chains of a sublane row, so they are consecutive
    (None on one thread a chain, whose blocks need not)."""
    if lanes == 1:
        return None
    return lambda threads: (chain_block // SUBLANES) % (threads // lanes) == 0


def walk_shape(lib, move, chain_block, grouped):
    """(threads, blocks per cluster) of a dense MH or MALA launch of the
    loaded build for chain blocks (tuning groups) of ``chain_block``."""
    lanes = lib.resident_walk_dense_lanes()
    return launch_shape(kernel_resources(lib, move),
                        lambda t, b: max_active_clusters(lib, move, t, b), chain_block * lanes,
                        grouped, consecutive(lanes, chain_block))


def walk_launch(lib, move, num_chains, chain_block, grouped, sm_count=None):
    """``lane_launch`` of the loaded MH or MALA move for ``num_chains``
    chains in chain blocks of ``chain_block``: lanes, threads, blocks,
    cluster, the card's occupancy and the SMs covered."""
    lanes = lib.resident_walk_dense_lanes()
    return lane_launch(num_chains, lanes, kernel_resources(lib, move), chain_block,
                       lambda t: max_active_blocks(lib, move, t),
                       lambda t, b: max_active_clusters(lib, move, t, b), grouped, sm_count,
                       consecutive(lanes, chain_block))


def tempering_launch(lib, move, num_chains, extras, ladder):
    """The launch of the loaded ladder move for ``num_chains`` chains:
    lanes, threads, blocks, the blocks an SM holds (the card's occupancy
    calculator on the build) and the SMs the first wave covers at least."""
    threads = ladder["threads"](num_chains)
    per_sm = max_active_blocks(lib, f"tempering_{move}", threads, extras)
    blocks = num_chains * ladder["lanes"] // threads
    return {"lanes": ladder["lanes"], "threads": threads, "blocks": blocks,
            "blocks_per_sm": per_sm,
            "sms_covered": min(ladder["sm_count"], -(-blocks // per_sm)) if per_sm else 0}


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
    version on the same tensors and also returns its info dict; a ladder's
    also takes the ``dtype`` it computes in and the list of its accept
    tests' ``margins`` (``resident_walk._run_tempering_plain``).
    ``fn.walk_launch(C, sm_count)`` and ``fn.tempering_launch(C)`` report
    the launch on the card (None off it)."""
    _check_chain_block(chain_block)
    device = torch.device(device)
    rungs = (None if temperatures is None
             else ladder_rungs(temperatures, chain_block // SUBLANES))
    if rungs is not None and tuner is not None:
        raise ValueError("the tempering move has no tuner")
    P = model.num_params
    n_rows = prepare_dense(model, x, y)[0].shape[0]
    vg = dense_plain_vg(model, x, y, with_grad=move == "mala")
    params = walk_params(move, value, num_iters, num_burnin_iters, record_thin, record_extras,
                         chain_block, tuner=tuner, sublanes=SUBLANES)
    if rungs is not None:
        set_ladder(params, rungs, between_step, move, value)
        rungs = torch.as_tensor(rungs, device=device)
    lib, shape, ladder = None, None, None
    if device.type == "cuda":
        if rungs is None:
            lib = load_kernel(model, x, y, lanes=walk_dense_lanes(n_rows, chain_block,
                                                                 tuner is not None, move))
            shape = walk_shape(lib, move, chain_block, grouped=tuner is not None)
        else:
            sm_count = torch.cuda.get_device_properties(device).multi_processor_count
            lanes = dense_tempering_lanes(n_rows, len(rungs), chain_block, sm_count)
            lib = load_kernel(model, x, y, lanes=lanes)
            max_threads = kernel_resources(lib, f"tempering_{move}")["max_threads_per_block"]
            # raises if no block fits
            ladder_threads(max_threads, chain_block, len(rungs), lanes, sublanes=SUBLANES)

            def ladder_block(C):
                return ladder_threads(max_threads, chain_block, len(rungs), lanes, C, sm_count,
                                      SUBLANES)

            ladder = dict(lanes=lanes, sm_count=sm_count, threads=ladder_block)
    setup = _setup(params, chain_block, device)

    def run_plain(pr, theta_t, dtype=torch.float32, margins=None):
        if rungs is None:
            return _run_walk_plain(vg, (), pr, move, chain_block, theta_t)
        samples, final, acc, info = _run_tempering_plain(vg, (), pr, move, rungs.to(dtype),
                                                         theta_t.to(dtype), margins)
        return samples, final, acc.T, info

    def fn(seed, theta0s):
        pr, theta_t = setup(seed, theta0s)
        if lib is None:
            samples, final, acc, _ = run_plain(pr, theta_t)
        elif rungs is None:
            samples, final, acc = resident_walk_dense(lib, move, theta_t, pr, *shape)
        else:
            samples, final, acc = resident_walk_dense_tempering(lib, move, theta_t, rungs, pr,
                                                                ladder["threads"](pr.num_chains))
            acc = acc.T
        if rungs is not None:
            last_info[TEMPERING_KERNEL] = {"accept_counts": acc}
        return unpack_outputs(samples, final, acc, P, record_extras)

    def plain(seed, theta0s, dtype=torch.float32, margins=None):
        pr, theta_t = setup(seed, theta0s)
        samples, final, acc, info = run_plain(pr, theta_t, dtype, margins)
        return unpack_outputs(samples, final, acc, P, record_extras), info

    fn.plain = plain
    fn.launch_shape = shape
    fn.walk_launch = lambda C, sm_count=None: (
        None if shape is None else walk_launch(lib, move, C, chain_block, tuner is not None,
                                               sm_count))
    fn.tempering_launch = lambda C: (
        None if ladder is None else tempering_launch(lib, move, C, record_extras, ladder))
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
