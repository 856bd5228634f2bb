"""The whole random-walk MH, MALA or blocked-Gibbs loop of a population of
MLP chains in one kernel, on data staged in shared memory.

Counterpart of the MH, MALA and Gibbs parts of
``eeyore_tpu/ops/resident_walk.py`` (``_make_resident``,
``make_resident_mh``, ``make_resident_mala``, ``make_resident_gibbs``).
Each maker returns ``fn(seed, theta0s [C, P]) -> (samples [kept, C, P], final
[C, P], accept_counts [C])`` (Gibbs: ``[C, B]``, per sub-block), plus
``target_val [kept, C]`` and ``accepted [kept, C]`` (int32, exact moved
flags) with ``record_extras``; accept counts are post-burn-in and every
``record_thin``-th post-burn-in state is kept.

- MH: a symmetric Normal walk of fixed ``scale`` on the value-only body (no
  backward pass); ``log_rate = v(prop) - v(theta)``.
- MALA: the Langevin proposal ``theta + (step/2) grad + sqrt(step) z`` with
  the full asymmetric Hastings correction; the two Normal densities'
  constants cancel, so ``log_rate = v(prop) - v(theta) - |theta - prop -
  (step/2) grad(prop)|^2 / (2 step) + |z|^2 / 2``.

- Gibbs: one systematic sweep per iteration over the sub-blocks of
  ``samplers.gibbs.Gibbs`` (node blocks, optionally split by
  ``chunk_evenly``); sub-block b proposes ``scale_b * z`` on its own
  coordinates, ``log_rate = v(prop) - v(theta)``, and a rejected proposal is
  restored before the next sub-block. ``moved`` is true when theta differs
  from theta at the start of the sweep.

All accept when ``log(u) < log_rate``. On CUDA tensors every call is one
launch of ``ops/csrc/resident_walk.cu`` (MH and MALA: a chain on
``WALK_LANES`` lanes of a warp, ``csrc/lane_eval.cuh``, or one thread a chain
on data of few rows, ``chain_lanes``); on CPU tensors it runs the plain
version ``_run_walk_plain`` (shared with ``ops/resident_walk_dense.py``), on
the same Threefry stream (``kernel_prng.walk_draws``: key (seed, chain),
counter (iteration, j)), or for Gibbs ``_run_gibbs_plain`` on the
incremental body ``mlp_math.make_incremental_gibbs`` and the Gibbs stream
(``kernel_prng.gibbs_draws``). The Gibbs kernel gives a chain
``GIBBS_LANES`` lanes of a warp, each caching the activations of its own data
rows in registers and recomputing only the moved unit and what lies
downstream (``csrc/lane_eval.cuh``); the build compiles in the Gibbs blocking
and whether the cache fits a lane (``gibbs_blocks_source``,
``gibbs_lane_plan``), and a model over that budget evaluates each proposal
by the whole value-only forward pass on the same lanes.

- Tempering (``temperatures``, the ladder of ``ops/resident_tempering.py``):
  L consecutive chains form a ladder, rung c % L at temperature T_rung, the
  coldest last. Each iteration is an MH or
  MALA move within each rung on the stored untempered value, with T at the
  accept test (MH: ``log_rate = T (v(prop) - v(theta))``; MALA: the drift
  ``theta + (step/2) T grad`` and ``log_rate = T (v(prop) - v(theta)) -
  |theta - prop - (step/2) T grad(prop)|^2 / (2 step) + |z|^2 / 2``), then,
  every ``between_step`` iterations, an even/odd round of adjacent swaps
  accepted when ``log(u) < (T_i - T_j)(v_j - v_i)``. It returns counts [C,
  2] (within-rung accepts, swap accepts on the lower member of a pair);
  with extras the values are untempered and ``moved`` compares theta after
  the swaps with theta at the start of the iteration. Its plain version is
  ``_run_tempering_plain``, on ``kernel_prng.tempering_draws``; on the card
  it is move 3 of the same library, a chain on ``TEMPERING_LANES`` lanes of a
  warp, or one thread a chain on data of few rows and for a ladder too long
  for a block of ``TEMPERING_BLOCK`` lane threads (``tempering_lanes``), in
  blocks that hold whole ladders (``ladder_threads``).
"""

import ctypes
import math

import numpy as np
import torch

from eeyore_tpu_torch.ops import _build, kernel_prng
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_math import (
    extract_arch,
    make_incremental_gibbs,
    make_vg,
    prepare_data,
)
from eeyore_tpu_torch.ops.resident_hmc import (
    LANE_MIN_ROWS,
    _population_tune,
    check_arch,
    group_index,
    group_means,
    raise_on,
    read_resources,
    unpack_outputs,
)
from eeyore_tpu_torch.ops.resident_hmc import check_lanes as check_walk_lanes
from eeyore_tpu_torch.ops.resident_hmc_dense import lane_launch, launch_shape

KERNEL = "resident_walk"
GIBBS_KERNEL = "resident_walk_gibbs"  # the Gibbs move of the same library, counted apart
TEMPERING_KERNEL = "resident_walk_tempering"  # the tempering move, counted apart
MOVES = {"mh": 0, "mala": 1, "gibbs": 2}
# The libraries' codes of each move's kernel, for their *_resources calls.
RESOURCE_CODES = {**MOVES, "tempering_mh": 3, "tempering_mala": 4}
# Threads per block: chains share nothing, so any multiple of 32 works. Every
# build can hold this many (at most 255 registers a thread), so a tempering
# ladder of up to WALK_BLOCK rungs always fits one block.
WALK_BLOCK = 256
# The Gibbs move: lanes of a warp a chain (8, 16 or 32), and the most floats
# of row cache a lane may hold in registers; a model and dataset over it take
# the whole forward pass on the same lanes.
GIBBS_LANES = 32
GIBBS_CACHE_BUDGET = 64
# Blocks of the Gibbs move (at most 256 threads) an SM must hold at once,
# which caps the registers the compiler may use (GIBBS_LANES and this are the
# fastest that scripts/lane_sweep.py measured on the H100, PERF.md, section 6).
GIBBS_MIN_BLOCKS = 3
LANE_COUNTS = (8, 16, 32)
# The MH and MALA moves: lanes of a warp a chain (1, 2, 4 or 8) on data of at
# least resident_hmc.LANE_MIN_ROWS rows, and the blocks of WALK_BLOCK threads
# an SM must hold at once, which caps the registers (the fastest that
# scripts/lane_sweep.py measured on the H100, PERF.md, section 6).
WALK_LANES = 8
WALK_MIN_BLOCKS = 2
# The ladder move: lanes of a warp a chain (1, 2, 4 or 8) on data of at least
# LANE_MIN_ROWS rows where a block of TEMPERING_BLOCK threads holds whole
# ladders, else one thread a chain (tempering_lanes), and the blocks of
# TEMPERING_BLOCK threads an SM must hold at once, which caps the registers
# (the fastest that scripts/lane_sweep.py measured on the H100, PERF.md,
# section 6).
TEMPERING_LANES = 8
TEMPERING_MIN_BLOCKS = 2
TEMPERING_BLOCK = 256

launch_counts = {KERNEL: 0, GIBBS_KERNEL: 0, TEMPERING_KERNEL: 0}
# What the last call of a Gibbs or tempering function returned as its accept
# counts ({"accept_counts": [C, B]} per sub-block, or [C, 2]: within-rung and
# swap accepts), for callers that go through dispatch.
last_info = {GIBBS_KERNEL: None, TEMPERING_KERNEL: None}


class ResidentWalkParams(ctypes.Structure):
    """The walk kernels' scalar arguments (``ResidentWalkParams`` in
    ``csrc/resident_loop.cuh``), shared with ``resident_walk_dense``."""

    _fields_ = ([(name, ctypes.c_int) for name in (
        "seed", "num_chains", "n_rows", "num_iters", "num_burnin_iters", "record_thin",
        "kept", "record_extras", "tuned", "sublanes", "chain_block")]
        + [(name, ctypes.c_float) for name in (
            "value", "half_step", "sqrt_step", "half_inv_step", "tuner_m", "d", "g", "t0",
            "k", "log_eub", "prior_const", "temperature")]
        + [(name, ctypes.c_int) for name in ("num_rungs", "between_step")])


def walk_params(move, value, num_iters, num_burnin_iters, record_thin, record_extras,
                chain_block, tuner=None, n_rows=0, prior_const=0.0, temperature=1.0,
                sublanes=1):
    """A filled ``ResidentWalkParams`` (without seed and chain count).
    ``value`` is the MH scale or the MALA step (unused by Gibbs, whose
    scales go to the kernel as an array); MALA's derived constants are
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


def gibbs_sub_blocks(model, scales=1.0, node_subblock_size=None):
    """The sweep of ``Gibbs(model, scales, node_subblock_size)``: [(flat
    indices, scale, (layer, node) of the unit the sub-block moves)]."""
    from eeyore_tpu_torch.samplers.gibbs import Gibbs

    blocking = Gibbs(model, scales=scales, node_subblock_size=node_subblock_size)
    return [(indices, scale, model.layer_and_node_from_par_block(block))
            for indices, scale, block in blocking.sub_blocks]


def check_lanes(lanes):
    """``lanes`` as an int, if it is a lane count a chain that the lane
    kernels take (8, 16 or 32, a divisor of a warp): else ValueError."""
    if int(lanes) not in LANE_COUNTS:
        raise ValueError(f"a chain takes 8, 16 or 32 lanes, not {lanes}")
    return int(lanes)


def gibbs_lane_plan(model, n_rows):
    """Whether the staged Gibbs move caches the activations of the rows
    (``n_rows``, padded) of ``model`` a lane of ``GIBBS_LANES``: each lane
    caches, for each of its ceil(n_rows / lanes) rows, the hidden
    activations (``row_floats``; the CE logits are recomputed), and for BCE
    one partial log-likelihood per output unit; the cache fits when that is
    at most ``GIBBS_CACHE_BUDGET`` floats. ``n_rows`` 0 (a build for the
    other moves) takes no cache."""
    lanes = check_lanes(GIBBS_LANES)
    dims, _, loss_kind, _ = extract_arch(model)
    row_floats = sum(dims[1:-1])
    rows_per_lane = -(-int(n_rows) // lanes)
    cache_floats = rows_per_lane * row_floats + (0 if loss_kind == "ce" else dims[-1])
    return {"lanes": lanes, "rows_per_lane": rows_per_lane, "row_floats": row_floats,
            "cache_floats": cache_floats, "budget": GIBBS_CACHE_BUDGET,
            "cached": n_rows > 0 and cache_floats <= GIBBS_CACHE_BUDGET}


def gibbs_blocks_source(model, node_subblock_size=None, n_rows=0):
    """The text of ``gibbs_blocks.cuh``: ``struct GibbsBlocks`` with the
    sweep's sub-block count ``kB`` and, as compile-time functions, each
    sub-block's ``width(b)``, flat indices ``index(b, k)`` and the node block
    ``unit(b)`` it moves (layer by layer, node by node), for the Gibbs moves
    of the walk kernels; and the staged move's lanes a chain ``kLanes``, the
    blocks an SM must hold ``kMinBlocks``, whether it caches the rows'
    activations (``kCached``, from ``gibbs_lane_plan`` for ``n_rows`` padded
    rows) and the rows a lane caches ``kRowsPerLane``. The row count enters
    the text only where the cache is taken, so the builds without it share
    one library."""
    from eeyore_tpu_torch.samplers.gibbs import Gibbs

    subs = [(indices, block) for indices, _, block in
            Gibbs(model, node_subblock_size=node_subblock_size).sub_blocks]
    stride = max(len(indices) for indices, _ in subs)
    plan = gibbs_lane_plan(model, n_rows)
    cached = plan["cached"]

    def switch(cases):
        return (["    switch (i) {"] + [f"      case {i}: return {v};" for i, v in cases]
                + ["      default: return -1;", "    }"])

    return "\n".join(
        ["// Generated by eeyore_tpu_torch/ops/resident_walk.py::gibbs_blocks_source for one",
         "// model and Gibbs blocking. Do not edit.", "#pragma once", "", "struct GibbsBlocks {",
         f"  static constexpr int kB = {len(subs)};",
         f"  static constexpr int kLanes = {plan['lanes']};",
         f"  static constexpr int kMinBlocks = {GIBBS_MIN_BLOCKS};",
         f"  static constexpr bool kCached = {'true' if cached else 'false'};",
         f"  static constexpr int kRowsPerLane = {plan['rows_per_lane'] if cached else 0};",
         "  __host__ __device__ static constexpr int width(int i) {",
         *switch((b, len(indices)) for b, (indices, _) in enumerate(subs)), "  }",
         "  __host__ __device__ static constexpr int unit(int i) {",
         *switch((b, unit) for b, (_, unit) in enumerate(subs)), "  }",
         "  __host__ __device__ static constexpr int index(int b, int k) {",
         f"    const int i = b * {stride} + k;",
         *switch((b * stride + k, p) for b, (indices, _) in enumerate(subs)
                 for k, p in enumerate(indices)), "  }", "};", ""])


def chain_lanes(n_rows):
    """Lanes a chain of the staged MH and MALA moves on ``n_rows`` staged
    (padded) rows: ``WALK_LANES``, or 1 (one thread a chain) on fewer than
    ``LANE_MIN_ROWS`` rows, where a lane would get no rows to split. The
    chains share nothing, so no tuning group bounds it."""
    return check_walk_lanes(WALK_LANES) if n_rows >= LANE_MIN_ROWS else 1


def tempering_lanes(n_rows, num_rungs, chain_block):
    """Lanes a chain of the staged ladder move for ladders of ``num_rungs``
    rungs in chain blocks of ``chain_block`` chains on ``n_rows`` staged
    (padded) rows: ``TEMPERING_LANES`` where a block of at most
    ``TEMPERING_BLOCK`` threads holds whole ladders and divides the chain
    block's threads, else 1 (one thread a chain, blocks of up to 1024
    threads); 1 on fewer than ``LANE_MIN_ROWS`` rows too, where a lane would
    get no rows to split. So every ladder that ran on one thread a chain
    still runs, a ladder of ``WALK_BLOCK`` rungs on one thread a chain."""
    lanes = check_walk_lanes(TEMPERING_LANES)
    if n_rows < LANE_MIN_ROWS or not _ladder_sizes(TEMPERING_BLOCK, chain_block, num_rungs,
                                                   lanes):
        return 1
    return lanes


def library_spec(model, node_subblock_size=None, n_rows=0, lanes=None, ladder_lanes=None):
    """(name, source, defines, generated headers) of the walk build that
    ``load_kernel`` loads for these arguments, at the module's settings: the
    arguments of ``_build.load_library``."""
    lanes = check_walk_lanes(WALK_LANES if lanes is None else lanes)
    ladder_lanes = check_walk_lanes(TEMPERING_LANES if ladder_lanes is None else ladder_lanes)
    tag, defines = arch_defines(model)
    return (f"{KERNEL}_{tag}_l{lanes}_b{WALK_MIN_BLOCKS}_t{ladder_lanes}_b{TEMPERING_MIN_BLOCKS}",
            "resident_walk.cu",
            tuple(defines) + (f"WALK_LANES={lanes}", f"WALK_MIN_BLOCKS={WALK_MIN_BLOCKS}",
                              f"TEMPERING_LANES={ladder_lanes}",
                              f"TEMPERING_MIN_BLOCKS={TEMPERING_MIN_BLOCKS}"),
            {"gibbs_blocks.cuh": gibbs_blocks_source(model, node_subblock_size, n_rows)})


def load_kernel(model, node_subblock_size=None, n_rows=0, lanes=None, ladder_lanes=None):
    """Build (at first use) and load the walk kernels for ``model``'s
    architecture and the Gibbs blocking of ``node_subblock_size``, which
    they take as compile-time constants; the Gibbs move on ``GIBBS_LANES``
    lanes a chain, caching the rows' activations where ``gibbs_lane_plan``
    of ``n_rows`` padded rows says the cache fits (a library built for fewer
    rows than a launch gives refuses the launch); the MH and MALA moves on
    ``lanes`` lanes a chain (``WALK_LANES``, or 1: ``chain_lanes``), the
    ladder move on ``ladder_lanes`` (``TEMPERING_LANES``, or fewer:
    ``tempering_lanes``)."""
    spec = library_spec(model, node_subblock_size, n_rows, lanes, ladder_lanes)
    lib = _build.load_library(*spec)
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
    lib.resident_walk_gibbs_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.POINTER(ResidentWalkParams), ctypes.c_int]
        + [ctypes.c_void_p] * 4)
    lib.resident_walk_gibbs_launch.restype = ctypes.c_int
    lib.resident_walk_num_sub_blocks.argtypes = []
    lib.resident_walk_num_sub_blocks.restype = ctypes.c_int
    lib.resident_walk_gibbs_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.resident_walk_gibbs_layout.restype = ctypes.c_int
    lib.resident_walk_gibbs_max_blocks.argtypes = [ctypes.c_int, ctypes.c_int,
                                                   ctypes.POINTER(ctypes.c_int)]
    lib.resident_walk_gibbs_max_blocks.restype = ctypes.c_int
    lib.resident_walk_tempering_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7
        + [ctypes.POINTER(ResidentWalkParams), ctypes.c_int] + [ctypes.c_void_p] * 4)
    lib.resident_walk_tempering_launch.restype = ctypes.c_int
    lib.resident_walk_lanes.argtypes = []
    lib.resident_walk_lanes.restype = ctypes.c_int
    lib.resident_walk_max_blocks.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
    lib.resident_walk_max_blocks.restype = ctypes.c_int
    lib.resident_walk_tempering_lanes.argtypes = []
    lib.resident_walk_tempering_lanes.restype = ctypes.c_int
    lib.resident_walk_tempering_max_blocks.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.resident_walk_tempering_max_blocks.restype = ctypes.c_int
    check_arch(lib.resident_walk_arch, model, spec[0])
    return lib


def kernel_resources(lib, move):
    """``read_resources`` of the loaded ``move`` kernel (a key of
    ``RESOURCE_CODES``)."""
    return read_resources(lambda out: lib.resident_walk_resources(RESOURCE_CODES[move], out),
                          lib.resident_walk_error_string, KERNEL)


def gibbs_layout(lib):
    """The loaded Gibbs move's lanes a chain, whether it caches the rows'
    activations, the rows a lane caches and its cache floats a lane."""
    out = (ctypes.c_int * 4)()
    raise_on(lib.resident_walk_gibbs_layout(out), lib.resident_walk_error_string, GIBBS_KERNEL)
    return {"lanes": out[0], "cached": bool(out[1]), "rows_per_lane": out[2],
            "cache_floats": out[3]}


def gibbs_threads(lib, chain_block):
    """Threads a block of the loaded Gibbs move for chain blocks of
    ``chain_block`` chains: at most ``UNGROUPED_BLOCK``, dividing the chain
    block's threads (the chains share nothing)."""
    return launch_shape(kernel_resources(lib, "gibbs"), None,
                        chain_block * gibbs_layout(lib)["lanes"], grouped=False)[0]


def gibbs_launch(lib, num_chains, chain_block, n_rows, sm_count=None):
    """``lane_launch`` of the loaded Gibbs move for ``num_chains`` chains (a
    multiple of ``chain_block``) on ``n_rows`` staged rows: threads, blocks,
    the card's occupancy and the SMs covered."""
    def max_blocks(threads):
        out = ctypes.c_int(0)
        raise_on(lib.resident_walk_gibbs_max_blocks(threads, n_rows, ctypes.byref(out)),
                 lib.resident_walk_error_string, GIBBS_KERNEL)
        return out.value

    return lane_launch(num_chains, gibbs_layout(lib)["lanes"], kernel_resources(lib, "gibbs"),
                       chain_block, max_blocks, sm_count=sm_count)


def walk_threads(lib, move, chain_block):
    """Threads a block of a staged MH or MALA launch of the loaded build:
    ``launch_shape`` of the chain block's threads, at most
    ``UNGROUPED_BLOCK`` and dividing them, so that the blocks cover the
    chains exactly (the chains share nothing)."""
    return launch_shape(kernel_resources(lib, move), None,
                        chain_block * lib.resident_walk_lanes(), grouped=False)[0]


def walk_launch(lib, move, num_chains, chain_block, n_rows, sm_count=None):
    """``lane_launch`` of the loaded MH or MALA move for ``num_chains``
    chains in chain blocks of ``chain_block`` on ``n_rows`` staged rows:
    lanes, threads, blocks, the card's occupancy and the SMs covered."""
    def max_blocks(threads):
        out = ctypes.c_int(0)
        raise_on(lib.resident_walk_max_blocks(MOVES[move], threads, n_rows, ctypes.byref(out)),
                 lib.resident_walk_error_string, KERNEL)
        return out.value

    return lane_launch(num_chains, lib.resident_walk_lanes(), kernel_resources(lib, move),
                       chain_block, max_blocks, sm_count=sm_count)


def check_tensors(name, tensors):
    """Raise unless ``tensors`` are contiguous float32 CUDA tensors on one
    device."""
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 CUDA tensors")
        if t.device != first.device:
            raise ValueError(f"{name} takes its tensors on one device")


def resident_walk(lib, move, theta0, x, y, mask, loc, ivar, params, threads):
    """Launch the ``move`` kernel: theta0 [P, C] -> (samples [kept, rows,
    C], final [P, C], accepts [C]), f32 on one CUDA device, on the current
    stream."""
    P, C = theta0.shape
    check_tensors("resident_walk", (theta0, x, y, mask, loc, ivar))
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


def resident_walk_gibbs(lib, theta0, x, y, mask, loc, ivar, scales, params, threads):
    """Launch the Gibbs kernel: theta0 [P, C] -> (samples [kept, rows, C],
    final [P, C], accepts [B, C]), f32 on one CUDA device, on the current
    stream; ``scales`` [B] holds each sub-block's proposal scale."""
    P, C = theta0.shape
    check_tensors("resident_walk_gibbs", (theta0, x, y, mask, loc, ivar, scales))
    B = lib.resident_walk_num_sub_blocks()
    if params.num_chains != C or params.n_rows != x.shape[0] or loc.numel() != P or \
            scales.numel() != B:
        raise ValueError("resident_walk_gibbs: inconsistent shapes")
    rows = P + 2 if params.record_extras else P
    samples = torch.empty((params.kept, rows, C), dtype=torch.float32, device=theta0.device)
    final = torch.empty((P, C), dtype=torch.float32, device=theta0.device)
    accepts = torch.empty((B, C), dtype=torch.float32, device=theta0.device)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_walk_gibbs_launch(
        theta0.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(), loc.data_ptr(),
        ivar.data_ptr(), scales.data_ptr(), ctypes.byref(params), threads, samples.data_ptr(),
        final.data_ptr(), accepts.data_ptr(), stream)
    raise_on(err, lib.resident_walk_error_string, f"{GIBBS_KERNEL} launch failed")
    launch_counts[GIBBS_KERNEL] += 1
    return samples, final, accepts


def resident_walk_tempering(lib, move, theta0, x, y, mask, loc, ivar, temps, params, threads):
    """Launch the tempering kernel with ``move`` ("mh" or "mala") within
    each rung: theta0 [P, C] -> (samples [kept, rows, C], final [P, C],
    accepts [2, C]), f32 on one CUDA device, on the current stream;
    ``temps`` [L] holds each rung's temperature."""
    P, C = theta0.shape
    check_tensors("resident_walk_tempering", (theta0, x, y, mask, loc, ivar, temps))
    if params.num_chains != C or params.n_rows != x.shape[0] or loc.numel() != P or \
            temps.numel() != params.num_rungs:
        raise ValueError("resident_walk_tempering: inconsistent shapes")
    rows = P + 2 if params.record_extras else P
    samples = torch.empty((params.kept, rows, C), dtype=torch.float32, device=theta0.device)
    final = torch.empty((P, C), dtype=torch.float32, device=theta0.device)
    accepts = torch.empty((2, C), dtype=torch.float32, device=theta0.device)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_walk_tempering_launch(
        int(move == "mala"), theta0.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(),
        loc.data_ptr(), ivar.data_ptr(), temps.data_ptr(), ctypes.byref(params), threads,
        samples.data_ptr(), final.data_ptr(), accepts.data_ptr(), stream)
    raise_on(err, lib.resident_walk_error_string, f"{TEMPERING_KERNEL} launch failed")
    launch_counts[TEMPERING_KERNEL] += 1
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


def _run_gibbs_plain(init, updates, sub_blocks, pr, theta):
    """The Gibbs kernels' computation in PyTorch, on [P, C] tensors: ``init(theta)
    -> (val [C], cache)`` and ``updates[(l, j)](theta, cache) -> (val,
    cache)`` are an incremental value-only body; ``sub_blocks`` the sweep
    (``gibbs_sub_blocks``). Returns (samples [kept, rows, C], final [P, C],
    accepts [B, C], {"evaluations": C * (1 + num_iters * B)})."""
    P, C = theta.shape
    f32 = dict(dtype=torch.float32, device=theta.device)
    chains = torch.arange(C, dtype=torch.int64, device=theta.device)
    index = [torch.tensor(indices, dtype=torch.int64, device=theta.device)
             for indices, _, _ in sub_blocks]
    val, cache = init(theta)
    rows = P + 2 if pr.record_extras else P
    samples = torch.empty((pr.kept, rows, C), **f32)
    accepts = torch.zeros((len(sub_blocks), C), **f32)

    for t in range(pr.num_iters):
        moved = torch.zeros(C, dtype=torch.bool, device=theta.device)
        for b, (indices, scale, unit) in enumerate(sub_blocks):
            z, u = kernel_prng.gibbs_draws(pr.seed, chains, t, b, len(indices))
            prop = theta.clone()
            prop[index[b]] = theta[index[b]] + float(np.float32(scale)) * z
            v_p, cache_p = updates[unit](prop, cache)
            accept = torch.log(u) < v_p - val
            moved |= accept & torch.any(prop[index[b]] != theta[index[b]], dim=0)
            theta = torch.where(accept, prop, theta)
            val = torch.where(accept, v_p, val)
            cache = tuple(old if new is old else torch.where(accept, new, old)
                          for old, new in zip(cache, cache_p))
            if t >= pr.num_burnin_iters:
                accepts[b] += accept.to(torch.float32)

        since = t - pr.num_burnin_iters
        if since >= 0 and since % pr.record_thin == 0 and since // pr.record_thin < pr.kept:
            out = samples[since // pr.record_thin]
            out[:P] = theta
            if pr.record_extras:
                out[P] = val
                out[P + 1] = moved.to(torch.float32)
    return samples, theta, accepts, {"evaluations": C * (1 + pr.num_iters * len(sub_blocks))}


def _run_tempering_plain(vg, arrays, pr, move, rungs, theta, margins=None):
    """The tempering kernels' computation in PyTorch, on [P, C] tensors:
    ``rungs`` [L] float32 holds each rung's temperature, chain c is rung c %
    L of its ladder. Same inputs as ``resident_walk_tempering``; returns
    (samples [kept, rows, C], final [P, C], accepts [2, C], {"evaluations": C
    * (1 + num_iters)}). A lower member's partner is chain c + 1, which the
    ladder-major layout keeps in the same ladder, so the swaps are rolls of
    the chain axis by one. A list ``margins`` gets, per iteration, each
    chain's closest accept test, the smallest |log rate - log u| [C] of its
    within-rung test and (lower members) its swap test."""
    P, C = theta.shape
    f32 = dict(dtype=torch.float32, device=theta.device)
    chains = torch.arange(C, dtype=torch.int64, device=theta.device)
    L = pr.num_rungs
    rung = chains % L
    temps = rungs[rung]
    temps_upper = rungs[torch.clamp(rung + 1, max=L - 1)]
    top = rung == L - 1
    mala = move == "mala"
    if mala:
        val, grad = vg(theta, *arrays)
    else:
        val = vg(theta, *arrays)
    val = val[0]
    rows = P + 2 if pr.record_extras else P
    samples = torch.empty((pr.kept, rows, C), **f32)
    accepts = torch.zeros((2, C), **f32)

    for t in range(pr.num_iters):
        z, u, u_swap = kernel_prng.tempering_draws(pr.seed, chains, t, P)
        start = theta
        if mala:
            prop = (theta + pr.half_step * (temps * grad)) + pr.sqrt_step * z
            v_p, g_p = vg(prop, *arrays)
            v_p = v_p[0]
            d_rev = theta - (prop + pr.half_step * (temps * g_p))
            log_rate = ((temps * (v_p - val)) - pr.half_inv_step * torch.sum(d_rev * d_rev, dim=0)
                        + 0.5 * torch.sum(z * z, dim=0))
        else:
            prop = theta + pr.value * z
            v_p = vg(prop, *arrays)[0]
            log_rate = temps * (v_p - val)
        accept = torch.log(u) < log_rate
        closest = (log_rate - torch.log(u)).abs()
        theta = torch.where(accept, prop, theta)
        val = torch.where(accept, v_p, val)
        if mala:
            grad = torch.where(accept, g_p, grad)
        counting = t >= pr.num_burnin_iters
        if counting:
            accepts[0] += accept.to(torch.float32)
        if t % pr.between_step == 0:
            parity = (t // pr.between_step) % 2
            lower = (rung % 2 == parity) & ~top
            swap_rate = (temps - temps_upper) * (torch.roll(val, -1) - val)
            take_upper = lower & (torch.log(u_swap) < swap_rate)  # the lower member's view
            take_lower = torch.roll(take_upper, 1)                # the upper member's view
            closest = torch.where(lower, torch.minimum(closest, (swap_rate - torch.log(u_swap))
                                                       .abs()), closest)

            def exchange(a):
                return torch.where(take_upper, torch.roll(a, -1, dims=-1),
                                   torch.where(take_lower, torch.roll(a, 1, dims=-1), a))

            theta, val = exchange(theta), exchange(val)
            if mala:
                grad = exchange(grad)
            if counting:
                accepts[1] += take_upper.to(torch.float32)
        if margins is not None:
            margins.append(closest)

        since = t - pr.num_burnin_iters
        if since >= 0 and since % pr.record_thin == 0 and since // pr.record_thin < pr.kept:
            out = samples[since // pr.record_thin]
            out[:P] = theta
            if pr.record_extras:
                out[P] = val
                out[P + 1] = torch.any(theta != start, dim=0).to(torch.float32)
    return samples, theta, accepts, {"evaluations": C * (1 + pr.num_iters)}


def ladder_rungs(temperatures, lanes):
    """The ladder's temperatures as float32 [L], coldest last. The ladders
    lie end to end along ``lanes`` chains (the chain block on staged data, a
    sublane row of it on dense data), so L must divide ``lanes``."""
    rungs = np.asarray(temperatures, dtype=np.float32)
    if rungs.ndim != 1 or not rungs.size:
        raise ValueError(f"temperatures must be a non-empty 1-D array, got shape {rungs.shape}")
    if lanes % rungs.size:
        raise ValueError(f"{lanes} lanes of the chain block not a multiple of the ladder "
                         f"size {rungs.size}")
    return rungs


def set_ladder(params, rungs, between_step, move, value):
    """Fill the tempering fields of ``params``: the ladder size, the swap
    period, and for MALA ``0.5 / step`` rounded from float64 to float32, as
    both TPU tempering kernels take it (resident_tempering.py:122,
    resident_tempering_dense.py:92)."""
    if int(between_step) < 1:
        raise ValueError(f"between_step must be a positive integer, got {between_step}")
    params.num_rungs, params.between_step = len(rungs), int(between_step)
    if move == "mala":
        params.half_inv_step = float(np.float32(0.5 / float(value)))


def _ladder_sizes(max_threads, chain_block, num_rungs, lanes=1, sublanes=1):
    """Threads a block of a tempering launch can have, largest first:
    multiples of 32 that the build allows (``max_threads``), that divide the
    chain block's ``chain_block * lanes`` threads and hold whole ladders; on
    lanes a block's chains also divide the ``chain_block / sublanes`` chains
    of a sublane row (the dense layout's 8), so that they are consecutive."""
    return [t for t in range(min(max_threads, 1024) // 32 * 32, 31, -32)
            if (chain_block * lanes) % t == 0 and t % (num_rungs * lanes) == 0
            and (lanes == 1 or (chain_block // sublanes) % (t // lanes) == 0)]


def ladder_threads(max_threads, chain_block, num_rungs, lanes=1, num_chains=None,
                   sm_count=None, sublanes=1):
    """Threads per block of a tempering launch (``_ladder_sizes``): the
    largest up to ``WALK_BLOCK`` whose blocks of ``num_chains`` chains fill
    the card's ``sm_count`` SMs (without them, any up to ``WALK_BLOCK``),
    else the smallest, so that a launch of few ladders (a ladder's entry
    point runs one chain block) spreads its chains' serial loops over as
    many SMs as it can."""
    sizes = _ladder_sizes(max_threads, chain_block, num_rungs, lanes, sublanes)
    if not sizes:
        raise ValueError(f"a ladder of {num_rungs} rungs on {lanes} lanes a chain does not "
                         f"fit a block of at most {max_threads} threads that divides "
                         f"chain_block {chain_block}")
    fit = [t for t in sizes if t <= WALK_BLOCK
           and (num_chains is None or num_chains * lanes // t >= sm_count)]
    return fit[0] if fit else sizes[-1]


def _setup(params, chain_block, device):
    """``setup(seed, theta0s) -> (params with the seed and chain count,
    theta [P, C])`` of a walk function built for ``device``."""

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

    return setup


def _make_resident(model, x, y, num_iters, num_burnin_iters, chain_block, record_thin, move,
                   value, temperatures=None, between_step=None, record_extras=False,
                   device="cuda"):
    """Shared scaffold of the staged MH, MALA and tempering makers:
    ``fn(seed, theta0s [C, P])`` for ``move`` ("mh" with scale ``value``,
    "mala" with step ``value``); with a ladder's ``temperatures`` [L] and
    ``between_step``, the tempering move with ``move`` within each rung,
    returning counts [C, 2]. ``fn.plain(seed, theta0s)`` runs the plain
    version on the same tensors and also returns its info dict; a ladder's
    also takes the ``dtype`` it computes in and the list of its accept
    tests' ``margins`` (``_run_tempering_plain``)."""
    device = torch.device(device)
    rungs = None if temperatures is None else ladder_rungs(temperatures, chain_block)
    x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature = prepare_data(model, x, y)
    P = model.num_params
    params = walk_params(move, value, num_iters, num_burnin_iters, record_thin, record_extras,
                         chain_block, n_rows=x_pad.shape[0], prior_const=prior_const,
                         temperature=temperature)
    if rungs is not None:
        set_ladder(params, rungs, between_step, move, value)
        rungs = torch.as_tensor(rungs, device=device)
    arrays = [torch.as_tensor(a, device=device).contiguous()
              for a in (x_pad, y_pad, row_mask, loc, ivar)]
    vg = make_vg(model, x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature,
                 with_grad=move == "mala")
    n_rows = x_pad.shape[0]
    lib, threads, ladder = None, None, None
    if device.type == "cuda":
        if rungs is None:
            if chain_block % 32 != 0:
                raise ValueError(f"on the card chain_block must be a multiple of 32, "
                                 f"got {chain_block}")
            lib = load_kernel(model, lanes=chain_lanes(n_rows))
            threads = walk_threads(lib, move, chain_block)
        else:
            lanes = tempering_lanes(n_rows, len(rungs), chain_block)
            lib = load_kernel(model, ladder_lanes=lanes)
            max_threads = kernel_resources(lib, f"tempering_{move}")["max_threads_per_block"]
            sm_count = torch.cuda.get_device_properties(device).multi_processor_count
            ladder_threads(max_threads, chain_block, len(rungs), lanes)  # raises if none fits

            def ladder_block(C):
                return ladder_threads(max_threads, chain_block, len(rungs), lanes, C, sm_count)

            ladder = dict(lanes=lanes, sm_count=sm_count, threads=ladder_block)
    setup = _setup(params, chain_block, device)

    def run_plain(pr, theta_t, dtype=torch.float32, margins=None):
        if rungs is None:
            return _run_walk_plain(vg, arrays, pr, move, chain_block, theta_t)
        samples, final, acc, info = _run_tempering_plain(
            vg, [a.to(dtype) for a in arrays], pr, move, rungs.to(dtype), theta_t.to(dtype),
            margins)
        return samples, final, acc.T, info

    def fn(seed, theta0s):
        pr, theta_t = setup(seed, theta0s)
        if lib is None:
            samples, final, acc, _ = run_plain(pr, theta_t)
        elif rungs is None:
            samples, final, acc = resident_walk(lib, move, theta_t, *arrays, pr, threads)
        else:
            samples, final, acc = resident_walk_tempering(lib, move, theta_t, *arrays, rungs, pr,
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
    fn.walk_launch = lambda C, sm_count=None: (
        None if lib is None or rungs is not None
        else walk_launch(lib, move, C, chain_block, n_rows, sm_count))
    fn.tempering_launch = lambda C: (
        None if ladder is None else tempering_launch(lib, move, C, n_rows, record_extras, ladder))
    return fn


def tempering_launch(lib, move, num_chains, n_rows, extras, ladder):
    """The launch of the loaded ladder move for ``num_chains`` chains:
    lanes, threads, blocks, the blocks an SM holds (the card's occupancy
    calculator on the build) and the SMs the first wave covers at least."""
    threads = ladder["threads"](num_chains)
    out = ctypes.c_int(0)
    raise_on(lib.resident_walk_tempering_max_blocks(int(move == "mala"), threads, n_rows,
                                                    int(extras), ctypes.byref(out)),
             lib.resident_walk_error_string, TEMPERING_KERNEL)
    blocks = num_chains * ladder["lanes"] // threads
    per_sm = out.value
    return {"lanes": ladder["lanes"], "threads": threads, "blocks": blocks,
            "blocks_per_sm": per_sm,
            "sms_covered": min(ladder["sm_count"], -(-blocks // per_sm)) if per_sm else 0}


def make_resident_gibbs(model, x, y, scales=1.0, node_subblock_size=None, num_iters=1000,
                        num_burnin_iters=0, chain_block=512, record_thin=1, record_extras=False,
                        device="cuda"):
    """Whole-loop blocked Metropolis-within-Gibbs (``samplers/gibbs.py``
    semantics): one systematic sweep per iteration over the model's node
    (sub-)blocks, each proposed with its block's scale on its own coordinates
    and accepted on the full log target, value only. Returns per-chain
    per-sub-block accept counts [C, B]. The plain version runs the
    incremental body (``mlp_math.make_incremental_gibbs``); the kernel the
    same function on a chain's lanes, each caching its own rows'
    activations where they fit (``gibbs_lane_plan``). C must be a multiple
    of ``chain_block``. ``fn.gibbs_launch(C)`` gives the kernel's launch for
    C chains (None off the card)."""
    device = torch.device(device)
    sub_blocks = gibbs_sub_blocks(model, scales, node_subblock_size)
    x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature = prepare_data(model, x, y)
    P = model.num_params
    params = walk_params("gibbs", 0.0, num_iters, num_burnin_iters, record_thin, record_extras,
                         chain_block, n_rows=x_pad.shape[0], prior_const=prior_const,
                         temperature=temperature)
    arrays = [torch.as_tensor(a, device=device).contiguous()
              for a in (x_pad, y_pad, row_mask, loc, ivar)]
    scale_t = torch.tensor([scale for _, scale, _ in sub_blocks], dtype=torch.float32,
                           device=device)
    _, inc_init, inc_updates = make_incremental_gibbs(model, x_pad.shape[0], temperature,
                                                      prior_const)

    def init(theta):
        val, cache = inc_init(theta, *arrays)
        return val[0], cache

    def make_update(update):
        def update_val(theta, cache):
            val, cache = update(theta, *arrays, cache)
            return val[0], cache
        return update_val

    updates = {unit: make_update(f) for unit, f in inc_updates.items()}
    lib, threads = None, None
    if device.type == "cuda":
        lib = load_kernel(model, node_subblock_size, x_pad.shape[0])
        threads = gibbs_threads(lib, chain_block)
    setup = _setup(params, chain_block, device)

    def fn(seed, theta0s):
        pr, theta_t = setup(seed, theta0s)
        if lib is None:
            samples, final, acc, _ = _run_gibbs_plain(init, updates, sub_blocks, pr, theta_t)
        else:
            samples, final, acc = resident_walk_gibbs(lib, theta_t, *arrays, scale_t, pr,
                                                      threads)
        last_info[GIBBS_KERNEL] = {"accept_counts": acc.T}
        return unpack_outputs(samples, final, acc.T, P, record_extras)

    def plain(seed, theta0s):
        pr, theta_t = setup(seed, theta0s)
        samples, final, acc, info = _run_gibbs_plain(init, updates, sub_blocks, pr, theta_t)
        return unpack_outputs(samples, final, acc.T, P, record_extras), info

    fn.plain = plain
    fn.gibbs_launch = lambda C, sm_count=None: (
        None if lib is None else dict(gibbs_launch(lib, C, chain_block, x_pad.shape[0],
                                                   sm_count), **gibbs_layout(lib)))
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
