"""The whole fixed-budget NUTS loop of a population of MLP chains in one
kernel, on data of at most 32 rows folded into the code as constants.

Counterpart of ``eeyore_tpu/ops/resident_nuts_dense.py``.
``make_resident_nuts_dense`` returns ``fn(seed, theta0s, dense_input=False)
-> (samples [kept, C, P], final [C, P], accept_sums [C], divergent_sums
[C])`` (plus ``target_val [kept, C]`` and ``accepted [kept, C]`` with
``record_extras``), or with ``unstack_outputs=False`` the TPU layout's raw
tiles ``(samples [kept, rows*8, C/8], final [P*8, C/8], acc [8, C/8], div [8,
C/8])``, views of the kernel's [P, C] outputs. ``dense_input=True`` takes the
inits as [P*8, C/8] tiles. On CUDA tensors every call is one launch of
``ops/csrc/resident_nuts_dense.cu``, built for the model, its data
(``mlp_dense.dense_source``), the metric (``metric_source``), the depth and
the register cap ``NUTS_DENSE_BOUND``;
on CPU tensors it runs the plain version, ``resident_nuts._run_nuts_plain``
on ``mlp_dense.make_vg_dense``, with the same NUTS stream keyed by the global
chain index, so it draws per chain what a staged run of the same seed draws.

Tuning (``tuner``, an ``HMCDATuner`` without ``l``): one step per tuning
group, the TPU kernel's grid block of ``chain_block`` chains (a multiple of
1024), sublane-strided; a NaN group mean counts as 0. On the card a group
larger than one block is a thread-block cluster of up to 16 blocks, and a
``chain_block`` the card cannot hold raises. ``inv_mass`` [P] becomes
constants of the code, where an entry of 1 folds away: the all-ones metric
is no metric.
"""

import ctypes

import torch

from eeyore_tpu_torch.ops import _build
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_dense import _literal, dense_source
from eeyore_tpu_torch.ops.resident_hmc import (
    ResidentHMCParams,
    check_arch,
    raise_on,
    read_resources,
)
from eeyore_tpu_torch.ops.resident_hmc_dense import dense_plain_vg, launch_shape, theta_layout
from eeyore_tpu_torch.ops.resident_nuts import (
    _output_buffers,
    _run_nuts_plain,
    check_nuts_args,
    metric_arrays,
    nuts_params,
    unpack_nuts_outputs,
)

KERNEL = "resident_nuts_dense"
SUBLANES = 8
# Launch bounds of one block of this many threads an SM (0: none), which cap
# the registers: at 512, 128 registers, so a cluster of 16 blocks of 512
# holds JAX's tuning group of 8192 chains. The fastest that
# scripts/lane_sweep.py --kernels nuts_dense measured on the H100 (PERF.md,
# section 6).
NUTS_DENSE_BOUND = 512

launch_counts = {KERNEL: 0}
# {"accept_sums": [C], "divergent_sums": [C], "step": [C]} of the last call
# (each chain's final step).
last_info = {KERNEL: None}


def metric_source(inv_mass, mom_scale):
    """The text of ``nuts_metric.cuh``: ``nuts_metric::inv_mass(p)`` and
    ``nuts_metric::mom_scale(p)``, float32 constants of the code (1 where
    the entry is 1)."""
    parts = ["// Generated by eeyore_tpu_torch/ops/resident_nuts_dense.py::metric_source for",
             "// one diagonal metric. Do not edit.", "#pragma once", "",
             "namespace nuts_metric {", ""]
    for name, values in (("inv_mass", inv_mass), ("mom_scale", mom_scale)):
        parts += [f"__device__ __forceinline__ float {name}(int p) {{", "  switch (p) {"]
        parts += [f"    case {p}: return {_literal(v)};" for p, v in enumerate(values)
                  if float(v) != 1.0]
        parts += ["    default: return 1.0f;", "  }", "}", ""]
    parts += ["}  // namespace nuts_metric", ""]
    return "\n".join(parts)


def library_spec(model, x, y, max_depth, inv_mass=None):
    """(name, source, defines, generated headers) of the dense NUTS build
    for ``model``, the data, the depth and the metric at
    ``NUTS_DENSE_BOUND``: the arguments of ``_build.load_library``."""
    tag, defines = arch_defines(model)
    im, msc = metric_arrays(inv_mass, model.num_params)
    return (f"{KERNEL}_{tag}_d{int(max_depth)}_t{NUTS_DENSE_BOUND}", "resident_nuts_dense.cu",
            tuple(defines) + (f"NUTS_DEPTH={int(max_depth)}",
                              f"NUTS_DENSE_BOUND={NUTS_DENSE_BOUND}"),
            {"dense_body.cuh": dense_source(model, x, y),
             "nuts_metric.cuh": metric_source(im, msc)})


def load_kernel(model, x, y, max_depth, inv_mass=None):
    """Build (at first use) and load the dense NUTS kernel for ``model``,
    the data ``(x, y)``, the metric and the depth, which it takes as
    constants."""
    name, *spec = library_spec(model, x, y, max_depth, inv_mass)
    lib = _build.load_library(name, *spec)
    lib.resident_nuts_dense_launch.argtypes = (
        [ctypes.c_void_p, ctypes.POINTER(ResidentHMCParams), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 6)
    lib.resident_nuts_dense_launch.restype = ctypes.c_int
    lib.resident_nuts_dense_error_string.argtypes = [ctypes.c_int]
    lib.resident_nuts_dense_error_string.restype = ctypes.c_char_p
    for fn in (lib.resident_nuts_dense_arch, lib.resident_nuts_dense_resources):
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    lib.resident_nuts_dense_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                                     ctypes.POINTER(ctypes.c_int)]
    lib.resident_nuts_dense_max_clusters.restype = ctypes.c_int
    check_arch(lib.resident_nuts_dense_arch, model, name)
    return lib


def kernel_resources(lib):
    """Registers, local-memory bytes a thread and the most threads a block
    of the loaded dense NUTS kernel."""
    return read_resources(lib.resident_nuts_dense_resources,
                          lib.resident_nuts_dense_error_string, KERNEL)


def max_active_clusters(lib, threads, blocks):
    out = ctypes.c_int(0)
    raise_on(lib.resident_nuts_dense_max_clusters(threads, blocks, ctypes.byref(out)),
             lib.resident_nuts_dense_error_string, KERNEL)
    return out.value


def group_shape(lib, chain_block):
    """``launch_shape`` of a tuned run of this build."""
    return launch_shape(kernel_resources(lib), lambda t, b: max_active_clusters(lib, t, b),
                        chain_block, grouped=True)


def resident_nuts_dense(lib, theta0, params, threads, cluster_blocks):
    """Launch the kernel: theta0 [P, C] -> (samples [kept, rows, C], final
    [P, C], accept_sums [C], divergent_sums [C], each chain's final step
    [C]), f32 on one CUDA device, on the current stream."""
    if not theta0.is_cuda or theta0.dtype != torch.float32 or not theta0.is_contiguous():
        raise ValueError("resident_nuts_dense takes a contiguous float32 CUDA tensor")
    out = _output_buffers(theta0, params)
    stream = torch.cuda.current_stream(theta0.device).cuda_stream
    err = lib.resident_nuts_dense_launch(
        theta0.data_ptr(), ctypes.byref(params), threads, cluster_blocks,
        *(t.data_ptr() for t in out), stream)
    raise_on(err, lib.resident_nuts_dense_error_string, f"{KERNEL} launch failed")
    launch_counts[KERNEL] += 1
    return out


def make_resident_nuts_dense(model, x, y, step, max_depth, num_iters, num_burnin_iters=0,
                             chain_block=8192, record_thin=1, tuner=None, unstack_outputs=True,
                             inv_mass=None, record_extras=False, device="cuda"):
    """Build ``fn(seed, theta0s, dense_input=False)`` running the whole
    fixed-budget NUTS loop on data of at most 32 rows (outputs in the module
    docstring). C must be a multiple of ``chain_block``, itself a multiple
    of 1024. ``device`` is where ``fn``'s tensors live: on a CUDA device
    every call launches the kernel, on the CPU it runs the plain version;
    ``fn.plain`` runs the plain version on ``device``'s tensors."""
    check_nuts_args(max_depth, tuner)
    if chain_block % 1024:
        raise ValueError(f"chain_block must be a multiple of 1024, got {chain_block}")
    D = int(max_depth)
    device = torch.device(device)
    P = model.num_params
    im_np, msc_np = metric_arrays(inv_mass, P)
    im, msc = (torch.as_tensor(a, device=device)[:, None] for a in (im_np, msc_np))
    vg = dense_plain_vg(model, x, y)
    params = nuts_params(step, num_iters, num_burnin_iters, record_thin, tuner, record_extras,
                         chain_block, SUBLANES)
    lib, shape = None, None
    if device.type == "cuda":
        lib = load_kernel(model, x, y, D, inv_mass)
        if tuner is not None:
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

    def finish(samples, final, acc, div):
        if not unstack_outputs:
            C = final.shape[1]
            return (samples.reshape(samples.shape[0], rows * 8, C // 8),
                    final.reshape(P * 8, C // 8), acc.reshape(8, C // 8), div.reshape(8, C // 8))
        return unpack_nuts_outputs(samples, final, acc, div, P, record_extras)

    def fn(seed, theta0s, dense_input=False):
        if theta0s.device.type != device.type:
            raise ValueError(f"theta0s on {theta0s.device}, but the function was built for "
                             f"device={device}")
        pr, theta_t = setup(seed, theta0s, dense_input)
        if lib is None:
            *out, info = _run_nuts_plain(vg, (), pr, chain_block, D, theta_t, im, msc)
        else:
            *out, step = resident_nuts_dense(lib, theta_t, pr, *shape)
            info = {"step": step}
        last_info[KERNEL] = {"accept_sums": out[2], "divergent_sums": out[3], **info}
        return finish(*out)

    def plain(seed, theta0s, dense_input=False):
        """The plain version on ``device``'s tensors: ``fn``'s outputs and
        {"step": each chain's final step [C]}."""
        pr, theta_t = setup(seed, theta0s, dense_input)
        *out, info = _run_nuts_plain(vg, (), pr, chain_block, D, theta_t, im, msc)
        return finish(*out), info

    fn.plain = plain
    fn.launch_shape = shape
    return fn
