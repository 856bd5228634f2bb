"""The whole random-walk MH or MALA loop of a population of MLP chains in one
kernel, on data of at most 32 rows folded into the code as constants.

Counterpart of the MH and MALA parts of
``eeyore_tpu/ops/resident_walk_dense.py`` (``_make_resident_dense``,
``make_resident_mh_dense``, ``make_resident_mala_dense``). The makers return
``fn(seed, theta0s [C, P])`` with the outputs of ``ops/resident_walk.py``;
C must be a multiple of ``chain_block``, itself a multiple of 1024. The
moves and their algebra are those of ``resident_walk`` (with ``0.5 / step``
rounded in float32, as the TPU's dense kernel has it), on the dense body
(``mlp_dense``). On CUDA tensors every call is one launch of
``ops/csrc/resident_walk_dense.cu``, built for the model and its data; on
CPU tensors it runs the plain version ``resident_walk._run_walk_plain`` on
``make_vg_dense``.

With a ``tuner`` (an ``HMCDATuner``; ``d`` is the target acceptance, 0.234
for MH and 0.574 for MALA are the classic optima), the proposal scale or
the Langevin step is dual-averaged during burn-in on the mean acceptance
rate of each tuning group, the TPU kernel's sublane-strided grid block of
``chain_block`` chains, and frozen at its averaged value after
(``resident_walk._population_dual_average``). As in the JAX package, the
rates have no NaN guard: one chain's NaN rate stops its group's tuning. On
the card a group larger than a block is a thread-block cluster, as in
``resident_hmc_dense``. The blocked Gibbs move waits for its kernel.
"""

import ctypes

import torch

from eeyore_tpu_torch.ops import _build
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_dense import dense_source
from eeyore_tpu_torch.ops.resident_hmc import check_arch, raise_on, read_resources, unpack_outputs
from eeyore_tpu_torch.ops.resident_hmc_dense import SUBLANES, dense_plain_vg, launch_shape
from eeyore_tpu_torch.ops.resident_walk import (
    MOVES,
    ResidentWalkParams,
    _check_unported,
    _run_walk_plain,
    walk_params,
)

KERNEL = "resident_walk_dense"

launch_counts = {KERNEL: 0}


def load_kernel(model, x, y):
    """Build (at first use) and load both dense walk kernels for ``model``
    and the data ``(x, y)``, which they take as constants."""
    tag, defines = arch_defines(model)
    lib = _build.load_library(f"{KERNEL}_{tag}", "resident_walk_dense.cu", defines,
                              generated={"dense_body.cuh": dense_source(model, x, y)})
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
    check_arch(lib.resident_walk_dense_arch, model, f"{KERNEL}_{tag}")
    return lib


def kernel_resources(lib, move):
    """``read_resources`` of the loaded ``move`` kernel."""
    return read_resources(lambda out: lib.resident_walk_dense_resources(MOVES[move], out),
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


def _make_resident_dense(model, x, y, num_iters, num_burnin_iters, chain_block, record_thin,
                         move, value, tuner=None, acc_tiles=1, consts=(), record_extras=False,
                         device="cuda"):
    """Shared scaffold of the dense walk makers: ``fn(seed, theta0s [C,
    P])`` for ``move`` ("mh" with scale ``value``, "mala" with step
    ``value``); ``fn.plain(seed, theta0s)`` runs the plain version on the
    same tensors and also returns its info dict."""
    _check_unported(acc_tiles, consts)
    if chain_block % 1024:
        raise ValueError(f"chain_block must be a multiple of 1024, got {chain_block}")
    device = torch.device(device)
    P = model.num_params
    vg = dense_plain_vg(model, x, y, with_grad=move == "mala")
    params = walk_params(move, value, num_iters, num_burnin_iters, record_thin, record_extras,
                         chain_block, tuner=tuner, sublanes=SUBLANES)
    lib, shape = None, None
    if device.type == "cuda":
        lib = load_kernel(model, x, y)
        shape = launch_shape(kernel_resources(lib, move),
                             lambda t, b: max_active_clusters(lib, move, t, b), chain_block,
                             grouped=tuner is not None)

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
            samples, final, acc, _ = _run_walk_plain(vg, (), pr, move, chain_block, theta_t)
        else:
            samples, final, acc = resident_walk_dense(lib, move, theta_t, pr, *shape)
        return unpack_outputs(samples, final, acc, P, record_extras)

    def plain(seed, theta0s):
        pr, theta_t = setup(seed, theta0s)
        samples, final, acc, info = _run_walk_plain(vg, (), pr, move, chain_block, theta_t)
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
