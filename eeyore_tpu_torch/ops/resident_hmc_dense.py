"""The whole HMC loop of a population of MLP chains in one kernel, on data of
at most 32 rows folded into the code as constants.

Counterpart of ``eeyore_tpu/ops/resident_hmc_dense.py``.
``make_resident_hmc_dense`` returns ``fn(seed, theta0s, samples_buf=None,
dense_input=None) -> (samples [kept, C, P], final [C, P], accept_counts
[C])`` (plus ``target_val [kept, C]`` and ``accepted [kept, C]`` with
``record_extras``), or with ``unstack_outputs=False`` the TPU layout's raw
tiles ``(samples [kept, rows*8, C/8], final [P*8, C/8], acc [8, C/8])``
(chain ``c = s*(C/8) + column``), which are views of the kernel's [P, C]
chain-minor outputs. On CUDA tensors every call is one launch of
``ops/csrc/resident_hmc_dense.cu``, built for the model and its data
(``mlp_dense.dense_source``); on CPU tensors it runs the plain version,
``resident_hmc._run_plain`` on ``mlp_dense.make_vg_dense``, with the same
Threefry stream (``kernel_prng.hmc_draws``, keyed by the global chain index,
so an untuned run draws what an untuned ``resident_hmc`` run of the same
seed draws).

Tuning (``tuner``, an ``HMCDATuner``): ``tuner_mode="population"``
dual-averages one step per tuning group, the TPU kernel's grid block of
``chain_block`` chains (a multiple of 1024), sublane-strided; the l-rule sets
the trajectory length. ``"per_chain"`` gives each chain its own step on its
own rate, and its own l-rule trajectory when the tuner has ``l``. A NaN rate
statistic counts as 0. On the card a population group larger than one
block is a thread-block cluster of up to 16 blocks; ``launch_shape`` picks
the block and checks that the card can hold the cluster, and a
``chain_block`` it cannot hold raises.
"""

import ctypes

import torch

from eeyore_tpu_torch.ops import _build
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_dense import dense_source, make_vg_dense
from eeyore_tpu_torch.ops.resident_hmc import (
    MAX_CLUSTER,
    ResidentHMCParams,
    _run_plain,
    check_arch,
    hmc_params,
    raise_on,
    read_resources,
    unpack_outputs,
)

KERNEL = "resident_hmc_dense"
SUBLANES = 8
# Threads per block of a run whose blocks share nothing.
UNGROUPED_BLOCK = 256

launch_counts = {KERNEL: 0}
last_info = {KERNEL: None}


def load_kernel(model, x, y):
    """Build (at first use) and load the dense HMC kernel for ``model`` and
    the data ``(x, y)``, which it takes as constants."""
    tag, defines = arch_defines(model)
    lib = _build.load_library(f"{KERNEL}_{tag}", "resident_hmc_dense.cu", defines,
                              generated={"dense_body.cuh": dense_source(model, x, y)})
    lib.resident_hmc_dense_launch.argtypes = (
        [ctypes.c_void_p, ctypes.POINTER(ResidentHMCParams), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 5)
    lib.resident_hmc_dense_launch.restype = ctypes.c_int
    lib.resident_hmc_dense_error_string.argtypes = [ctypes.c_int]
    lib.resident_hmc_dense_error_string.restype = ctypes.c_char_p
    for fn in (lib.resident_hmc_dense_arch, lib.resident_hmc_dense_resources):
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    lib.resident_hmc_dense_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                                    ctypes.POINTER(ctypes.c_int)]
    lib.resident_hmc_dense_max_clusters.restype = ctypes.c_int
    check_arch(lib.resident_hmc_dense_arch, model, f"{KERNEL}_{tag}")
    return lib


def kernel_resources(lib):
    """``read_resources`` of the loaded dense HMC kernel."""
    return read_resources(lib.resident_hmc_dense_resources,
                          lib.resident_hmc_dense_error_string, KERNEL)


def block_sizes(chain_block, max_threads):
    """Thread counts that divide ``chain_block`` and that the registers
    allow, largest first."""
    top = min(max_threads, 1024) // 32 * 32
    return [t for t in range(top, 31, -32) if chain_block % t == 0]


def launch_shape(resources, max_clusters, chain_block, grouped):
    """(threads per block, blocks per cluster) of a launch. A run whose
    chains share nothing (untuned or per-chain) takes blocks of at most
    ``UNGROUPED_BLOCK`` threads and no cluster. A population-tuned run needs
    its group of ``chain_block`` threads (a thread a chain here; the lane
    kernels pass chains x lanes) in one block, or in one cluster of
    at most ``MAX_CLUSTER`` blocks that ``max_clusters(threads, blocks)``
    says the card can hold; the largest block that works is taken, and
    none raises."""
    sizes = block_sizes(chain_block, resources["max_threads_per_block"])
    if not grouped:
        return next(t for t in sizes if t <= UNGROUPED_BLOCK), 1
    for threads in sizes:
        blocks = chain_block // threads
        if blocks > MAX_CLUSTER:
            break
        if blocks == 1 or max_clusters(threads, blocks) >= 1:
            return threads, blocks
    raise ValueError(f"a tuning group of {chain_block} threads does not fit one cluster of "
                     f"at most {MAX_CLUSTER} blocks on this card at "
                     f"{resources['registers']} registers a thread")


def lane_launch(num_chains, lanes, resources, chain_block, max_blocks, max_clusters=None,
                grouped=False, sm_count=None):
    """The launch of ``num_chains`` chains of ``lanes`` threads each (the
    staged Gibbs move and NUTS kernel): ``launch_shape`` of a group of
    ``chain_block`` chains (``chain_block * lanes`` threads), its blocks,
    and what the card says of them: ``max_blocks(threads)`` blocks an SM
    holds at once (the CUDA runtime's occupancy calculator on the build, at
    the launch's shared memory) and, for a cluster, ``max_clusters(threads,
    blocks)`` clusters the card holds at once. With the card's ``sm_count``
    also the blocks resident at once, the waves, and the SMs the first wave
    covers at least (no SM holds more than ``blocks_per_sm`` of them)."""
    threads, cluster = launch_shape(resources, max_clusters, chain_block * lanes, grouped)
    blocks = num_chains * lanes // threads
    per_sm = max_blocks(threads)
    out = {"lanes": lanes, "threads": threads, "blocks": blocks, "cluster_blocks": cluster,
           "blocks_per_sm": per_sm, "resident_blocks": None, "waves": None, "sms_covered": None}
    if sm_count is not None:
        resident = per_sm * sm_count if cluster == 1 else max_clusters(threads, cluster) * cluster
        out.update(resident_blocks=resident,
                   waves=-(-blocks // resident) if resident else None,
                   sms_covered=min(sm_count, -(-min(blocks, resident) // per_sm)) if per_sm else 0)
    return out


def max_active_clusters(lib, threads, blocks):
    out = ctypes.c_int(0)
    raise_on(lib.resident_hmc_dense_max_clusters(threads, blocks, ctypes.byref(out)),
             lib.resident_hmc_dense_error_string, KERNEL)
    return out.value


def group_shape(lib, chain_block):
    """``launch_shape`` of a population-tuned run of this build."""
    return launch_shape(kernel_resources(lib), lambda t, b: max_active_clusters(lib, t, b),
                        chain_block, grouped=True)


def resident_hmc_dense(lib, theta0, params, threads, cluster_blocks, samples=None):
    """Launch the kernel: theta0 [P, C] -> (samples [kept, rows, C], final
    [P, C], accepts [C], {"evaluations": int64 0-d tensor}), f32 on one CUDA
    device, on the current stream. ``samples``, if given, is the output
    buffer (written in place)."""
    P, C = theta0.shape
    if not theta0.is_cuda or theta0.dtype != torch.float32 or not theta0.is_contiguous():
        raise ValueError("resident_hmc_dense takes a contiguous float32 CUDA tensor")
    if params.num_chains != C:
        raise ValueError("resident_hmc_dense: inconsistent shapes")
    rows = P + 2 if params.record_extras else P
    shape = (params.kept, rows, C)
    if samples is None:
        samples = torch.empty(shape, dtype=torch.float32, device=theta0.device)
    elif (samples.shape != shape or samples.dtype != torch.float32
          or not samples.is_contiguous() or samples.device != theta0.device):
        raise ValueError(f"samples_buf must be a contiguous float32 tensor of {shape} elements "
                         "on theta0s' device")
    final = torch.empty((P, C), dtype=torch.float32, device=theta0.device)
    accepts = torch.empty((C,), dtype=torch.float32, device=theta0.device)
    evaluations = torch.zeros((), dtype=torch.int64, device=theta0.device)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_hmc_dense_launch(
        theta0.data_ptr(), ctypes.byref(params), threads, cluster_blocks, samples.data_ptr(),
        final.data_ptr(), accepts.data_ptr(), evaluations.data_ptr(), stream)
    raise_on(err, lib.resident_hmc_dense_error_string, f"{KERNEL} launch failed")
    launch_counts[KERNEL] += 1
    return samples, final, accepts, {"evaluations": evaluations}


def dense_plain_vg(model, x, y, with_grad=True):
    """``make_vg_dense`` on [P, C] tensors: ``vg(theta) -> (val [1, C],
    grad [P, C])`` (or ``val [1, C]``), the form ``_run_plain`` takes."""
    vg_tiles = make_vg_dense(model, x, y, with_grad=with_grad)

    def vg(theta):
        if not with_grad:
            return vg_tiles(tuple(theta))[None]
        val, grads = vg_tiles(tuple(theta))
        return val[None], torch.stack(grads)

    return vg


def theta_layout(theta0s, P, dense_input):
    """theta0s as [P, C] float32 (contiguous): chain-major [C, P] input, or
    the TPU's [P*8, C/8] tiles with ``dense_input`` (inferred from the shape
    when None; the shape [P*8, P] is ambiguous and raises)."""
    if dense_input is None:
        looks_dense = theta0s.dim() == 2 and theta0s.shape[0] == P * 8 and theta0s.shape[1] != P
        looks_chain_major = theta0s.dim() == 2 and theta0s.shape[1] == P
        if looks_chain_major and theta0s.shape[0] == P * 8:
            raise ValueError(f"ambiguous theta0s shape {tuple(theta0s.shape)}: [P*8, P] reads "
                             "as both chain-major and dense tiles; pass dense_input=True/False "
                             "explicitly")
        dense_input = looks_dense
    if dense_input:
        if theta0s.dim() != 2 or theta0s.shape[0] != P * 8:
            raise ValueError(f"dense_input=True needs [P*8={P * 8}, C/8] tiles, got "
                             f"{tuple(theta0s.shape)}")
        return theta0s.to(torch.float32).reshape(P, -1).contiguous()
    return theta0s.to(torch.float32).T.contiguous()


def make_resident_hmc_dense(model, x, y, step, num_steps, num_iters, num_burnin_iters=0,
                            chain_block=8192, record_thin=1, tuner=None, max_num_steps=64,
                            unstack_outputs=True, tuner_mode="population",
                            l_rounding="round", record_extras=False, device="cuda"):
    """Build ``fn(seed, theta0s, samples_buf=None, dense_input=None)`` running
    the whole HMC loop on data of at most 32 rows (see the module docstring
    for the outputs). C must be a multiple of ``chain_block``, itself a
    multiple of 1024. ``device`` is where ``fn``'s tensors live: on a CUDA
    device every call launches the kernel, on the CPU it runs the plain
    version. ``samples_buf`` is an output buffer of the raw samples' shape
    ``[kept, rows*8, C/8]`` (rows = P, or P + 2 with extras), written in
    place."""
    if tuner_mode not in ("population", "per_chain"):
        raise ValueError(f"unknown tuner_mode {tuner_mode!r}")
    if l_rounding not in ("round", "stochastic"):
        raise ValueError(f"l_rounding must be 'round' or 'stochastic', got {l_rounding!r}")
    if chain_block % 1024:
        raise ValueError(f"chain_block must be a multiple of 1024, got {chain_block}")
    per_chain = tuner is not None and tuner_mode == "per_chain"
    if tuner is not None and not per_chain and tuner.l is None:
        raise ValueError("population tuning needs the trajectory length l (HMCDATuner(l=...))")
    device = torch.device(device)
    P = model.num_params
    vg = dense_plain_vg(model, x, y)
    params = hmc_params(step, num_steps, num_iters, num_burnin_iters, record_thin, tuner,
                        max_num_steps, l_rounding, record_extras, chain_block,
                        per_chain=per_chain)
    params.nan_guard, params.sublanes = 1, SUBLANES
    lib, shape = None, None
    if device.type == "cuda":
        lib = load_kernel(model, x, y)
        if tuner is not None and not per_chain:
            shape = group_shape(lib, chain_block)
        else:
            shape = launch_shape(kernel_resources(lib), None, chain_block, grouped=False)
    rows = P + 2 if record_extras else P

    def setup(seed, theta0s, dense_input):
        theta_t = theta_layout(theta0s, P, dense_input)
        C = theta_t.shape[1]
        if C % chain_block != 0:
            raise ValueError(f"{C} chains not a multiple of chain_block {chain_block}")
        pr = ResidentHMCParams.from_buffer_copy(params)
        pr.seed, pr.num_chains = int(seed), C
        return pr, theta_t

    def finish(samples, final, acc):
        if not unstack_outputs:
            C = final.shape[1]
            return (samples.reshape(samples.shape[0], rows * 8, C // 8),
                    final.reshape(P * 8, C // 8), acc.reshape(8, C // 8))
        return unpack_outputs(samples, final, acc, P, record_extras)

    def fn(seed, theta0s, samples_buf=None, dense_input=None):
        if theta0s.device.type != device.type:
            raise ValueError(f"theta0s on {theta0s.device}, but the function was built for "
                             f"device={device}")
        pr, theta_t = setup(seed, theta0s, dense_input)
        buf = None
        if samples_buf is not None:
            buf = samples_buf.view(pr.kept, rows, pr.num_chains)
        if lib is None:
            samples, final, acc, info = _run_plain(vg, (), pr, chain_block, theta_t)
            if buf is not None:
                samples = buf.copy_(samples)
        else:
            samples, final, acc, info = resident_hmc_dense(lib, theta_t, pr, *shape,
                                                           samples=buf)
        last_info[KERNEL] = {"evaluations": info["evaluations"]}
        return finish(samples, final, acc)

    def plain(seed, theta0s, dense_input=None):
        """The plain version on ``device``'s tensors: ``fn``'s outputs and
        {"evaluations": int, "step" and "num_steps": [C]}."""
        pr, theta_t = setup(seed, theta0s, dense_input)
        samples, final, acc, info = _run_plain(vg, (), pr, chain_block, theta_t)
        return finish(samples, final, acc), dict(info, evaluations=int(info["evaluations"]))

    fn.plain = plain
    fn.launch_shape = shape
    return fn
