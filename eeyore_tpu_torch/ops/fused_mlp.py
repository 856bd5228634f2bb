"""Fused log-posterior and gradient for a population of MLP chains.

Counterpart of ``eeyore_tpu/ops/fused_mlp.py``. ``make_fused_log_target_vg``
returns ``fn(thetas [C, P]) -> (values [C], grads [C, P])``, the tempered log
posterior and its gradient for every chain in one launch of the CUDA kernel
``ops/csrc/fused_mlp_vg.cu``, which reads ``thetas`` and writes the gradient
in that layout, as the caller holds them. A chain takes ``FUSED_LANES``
lanes of a warp on data of at least ``resident_hmc.LANE_MIN_ROWS`` padded
rows (``fused_lanes``), each lane running the staged rows of its own, and
one thread on fewer rows. Any ``C`` works: the TPU's ``chain_block`` tiling
has no counterpart here (``fused_threads`` picks the block).

Built for ``device="cpu"``, the function runs the plain version,
``mlp_math.make_vg``; built for a CUDA device, it launches the kernel on every
call, and the kernel's wrapper ``fused_mlp_vg`` raises on anything but CUDA
tensors. There is no fallback from one to the other. The fixed data arrays
are checked once, by ``fused_data``, when the function is built; each call
checks ``thetas`` only.
"""

import ctypes
from typing import NamedTuple

import torch

from eeyore_tpu_torch.ops import _build
from eeyore_tpu_torch.ops.mlp_math import extract_arch, make_vg, prepare_data

KERNEL = "fused_mlp_vg"
# A chain's lanes of a warp (1, 2, 4 or 8) on data of at least LANE_MIN_ROWS
# padded rows, and the blocks of the build's most threads (kBlockThreads in
# the source) an SM must hold at once, which caps the registers: the fastest
# that scripts/lane_sweep.py --kernels fused measured on the H100 (PERF.md,
# section 6).
FUSED_LANES = 4
FUSED_MIN_BLOCKS = 2
LANE_COUNTS = (1, 2, 4, 8)

# Launches of each kernel of this module, counted where they happen.
launch_counts = {KERNEL: 0}


def arch_defines(model):
    """(name tag, ``-D`` defines) of ``model``'s architecture, which the
    kernels of ``csrc/mlp_vg.cuh`` take as compile-time constants."""
    dims, bias, loss_kind, _ = extract_arch(model)
    if len(dims) > 8 or max(dims) > 255:
        raise ValueError(f"the MLP kernels take at most 7 layers of width <= 255, got {dims}")
    tag = "{}_b{}_{}".format("x".join(map(str, dims)), "".join(str(int(b)) for b in bias),
                             loss_kind)
    defines = (f"FMV_NUM_LAYERS={len(dims) - 1}",
               f"FMV_DIMS={sum(d << (8 * l) for l, d in enumerate(dims)):#x}",
               f"FMV_BIAS={sum(1 << l for l, b in enumerate(bias) if b):#x}",
               f"FMV_CE={int(loss_kind == 'ce')}")
    return tag, defines


def check_lanes(lanes):
    """``lanes`` as an int, if a chain of the fused kernel takes that many
    lanes (1, 2, 4 or 8): else ValueError."""
    if int(lanes) not in LANE_COUNTS:
        raise ValueError(f"a chain of the fused kernel takes 1, 2, 4 or 8 lanes, not {lanes}")
    return int(lanes)


def fused_lanes(n_rows):
    """Lanes a chain of the fused kernel on ``n_rows`` staged (padded) rows:
    ``FUSED_LANES``, or 1 (one thread a chain) on fewer than
    ``resident_hmc.LANE_MIN_ROWS`` rows, where a lane would get next to no
    rows."""
    from eeyore_tpu_torch.ops.resident_hmc import LANE_MIN_ROWS

    return check_lanes(FUSED_LANES) if n_rows >= LANE_MIN_ROWS else 1


def library_spec(model, lanes=None):
    """(name, source, defines) of the fused kernel's build for ``model``'s
    architecture on ``lanes`` lanes a chain (``FUSED_LANES`` by default) at
    ``FUSED_MIN_BLOCKS``: the arguments of ``_build.load_library``."""
    lanes = check_lanes(FUSED_LANES if lanes is None else lanes)
    tag, defines = arch_defines(model)
    return (f"{KERNEL}_{tag}_l{lanes}_b{FUSED_MIN_BLOCKS}", "fused_mlp_vg.cu",
            tuple(defines) + (f"FUSED_LANES={lanes}", f"FUSED_MIN_BLOCKS={FUSED_MIN_BLOCKS}"))


def bind(lib):
    """Declare the C interface of a fused build to ctypes; returns ``lib``."""
    lib.fused_mlp_vg_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 3)
    lib.fused_mlp_vg_launch.restype = ctypes.c_int
    lib.fused_mlp_vg_error_string.argtypes = [ctypes.c_int]
    lib.fused_mlp_vg_error_string.restype = ctypes.c_char_p
    lib.fused_mlp_vg_arch.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.fused_mlp_vg_arch.restype = ctypes.c_int
    lib.fused_mlp_vg_lanes.argtypes = []
    lib.fused_mlp_vg_lanes.restype = ctypes.c_int
    lib.fused_mlp_vg_resources.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.fused_mlp_vg_resources.restype = ctypes.c_int
    lib.fused_mlp_vg_max_blocks.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.fused_mlp_vg_max_blocks.restype = ctypes.c_int
    return lib


def load_kernel(model, lanes=None):
    """Build (at first use) and load the fused kernel for ``model``'s
    architecture and ``lanes`` lanes a chain (``library_spec``), which it
    takes as compile-time constants."""
    dims, _, loss_kind, _ = extract_arch(model)
    name, source, defines = library_spec(model, lanes)
    lib = bind(_build.load_library(name, source, defines))
    arch = _arch(lib)
    expected = [model.num_params, dims[0], dims[-1], int(loss_kind == "ce")]
    if arch[:4] != expected:
        raise _build.KernelError(f"{name}: library built for {arch[:4]}, model needs {expected}")
    return lib


def _arch(lib):
    """[num_params, input width, output width, cross-entropy flag, most
    threads a block] of the loaded build."""
    arch = (ctypes.c_int * 5)()
    lib.fused_mlp_vg_arch(arch)
    return list(arch)


def _raise_on(lib, err, what):
    if err != 0:
        raise _build.KernelError(f"{what}: {lib.fused_mlp_vg_error_string(err).decode()}")


def kernel_resources(lib):
    """Registers per thread, local-memory bytes per thread (spills) and the
    most threads a block can have with those registers, of the loaded
    kernel, as the CUDA runtime reports them."""
    out = (ctypes.c_int * 3)()
    _raise_on(lib, lib.fused_mlp_vg_resources(out), KERNEL)
    return {"registers": out[0], "local_bytes": out[1], "max_threads_per_block": out[2]}


def max_active_blocks(lib, threads, n_rows):
    """Blocks of ``threads`` threads an SM holds at once for ``n_rows``
    staged rows (the card's occupancy calculator on the build)."""
    out = ctypes.c_int(0)
    _raise_on(lib, lib.fused_mlp_vg_max_blocks(threads, n_rows, ctypes.byref(out)), KERNEL)
    return out.value


def fused_threads(lanes, num_chains, sm_count, max_threads, max_blocks=None):
    """Threads a block of a launch for ``num_chains`` chains on ``lanes``
    lanes each, of the multiples of 32 up to the most threads a block of
    the build takes (``max_threads``) and, given the card's occupancy
    calculator ``max_blocks(threads)``, that an SM holds: the largest, when
    its blocks give every SM two or more (the card then balances them, and a
    block copies the data once for more chains); else the one whose busiest
    SM gets the fewest threads (ceil(blocks / sm_count) blocks), ties broken
    by more SMs covered, then by the larger block."""
    sizes = [t for t in range(max_threads // 32 * 32, 31, -32)
             if max_blocks is None or max_blocks(t) >= 1]
    if not sizes:
        raise ValueError(f"{KERNEL}: no block of its threads fits an SM")
    threads = num_chains * lanes
    if -(-threads // sizes[0]) >= 2 * sm_count:
        return sizes[0]

    def key(t):
        blocks = -(-threads // t)
        return -(-blocks // sm_count) * t, -min(blocks, sm_count), -t

    return min(sizes, key=key)


def fused_launch(lib, num_chains, n_rows, sm_count):
    """The launch of the loaded build for ``num_chains`` chains on
    ``n_rows`` staged rows and a card of ``sm_count`` SMs: lanes, threads,
    blocks, the blocks an SM holds (the card's occupancy calculator), the
    waves and the SMs the first wave covers."""
    lanes = lib.fused_mlp_vg_lanes()
    max_threads = min(_arch(lib)[4], kernel_resources(lib)["max_threads_per_block"])
    threads = fused_threads(lanes, num_chains, sm_count, max_threads,
                            lambda t: max_active_blocks(lib, t, n_rows))
    blocks = -(-num_chains * lanes // threads)
    per_sm = max_active_blocks(lib, threads, n_rows)
    return {"lanes": lanes, "threads": threads, "blocks": blocks, "blocks_per_sm": per_sm,
            "waves": -(-blocks // (per_sm * sm_count)),
            "sms_covered": min(sm_count, -(-blocks // per_sm))}


class FusedData(NamedTuple):
    """The kernel's fixed arguments, checked once by ``fused_data``."""
    tensors: tuple      # x [n_rows, in], y [n_rows, out], mask, loc [P], ivar [P]
    pointers: tuple     # their data pointers
    n_rows: int
    num_params: int
    prior_const: float
    temperature: float
    device: torch.device


def fused_data(x, y, mask, loc, ivar, prior_const, temperature):
    """The padded data and prior arrays (``mlp_math.prepare_data``) as the
    kernel's fixed arguments: contiguous float32 tensors on one CUDA device
    of consistent shapes, else ValueError."""
    tensors = (x, y, mask, loc, ivar)
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_mlp_vg takes contiguous float32 CUDA tensors")
        if t.device != x.device:
            raise ValueError("fused_mlp_vg takes its tensors on one device")
    n_rows, P = x.shape[0], loc.numel()
    if y.shape[0] != n_rows or mask.numel() != n_rows or ivar.numel() != P:
        raise ValueError("fused_mlp_vg: inconsistent shapes")
    return FusedData(tensors, tuple(t.data_ptr() for t in tensors), n_rows, P,
                     float(prior_const), float(temperature), x.device)


def fused_mlp_vg(lib, thetas, data, threads):
    """Launch the kernel: thetas [C, P] -> (vals [C], grads [C, P]), f32 on
    one CUDA device, on the current stream, on ``data`` (``fused_data``) in
    blocks of ``threads`` (``fused_threads``)."""
    if not thetas.is_cuda or thetas.dtype != torch.float32 or not thetas.is_contiguous():
        raise ValueError("fused_mlp_vg takes contiguous float32 CUDA tensors")
    if thetas.device != data.device:
        raise ValueError("fused_mlp_vg takes its tensors on one device")
    if thetas.dim() != 2 or thetas.shape[1] != data.num_params:
        raise ValueError("fused_mlp_vg: inconsistent shapes")
    C = thetas.shape[0]
    if C == 0:
        raise ValueError("fused_mlp_vg needs at least one chain")
    vals = torch.empty((C,), dtype=torch.float32, device=thetas.device)
    grads = torch.empty((C, data.num_params), dtype=torch.float32, device=thetas.device)
    stream = torch.cuda.current_stream(thetas.device).cuda_stream
    err = lib.fused_mlp_vg_launch(
        thetas.data_ptr(), *data.pointers, data.prior_const, data.temperature, data.n_rows, C,
        threads, vals.data_ptr(), grads.data_ptr(), stream)
    _raise_on(lib, err, f"{KERNEL} launch failed")
    launch_counts[KERNEL] += 1
    return vals, grads


def make_fused_log_target_vg(model, x, y, device="cuda"):
    """Build ``fn(thetas [C, P]) -> (values [C], grads [C, P])`` in float32.

    ``model``: an ``eeyore_tpu_torch.models.MLP`` with an ``IIDNormalPrior``
    and the registered BCE or CE loss. On a CUDA ``device`` every call
    launches the hand-written kernel, which takes ``thetas`` and returns the
    gradient ``[C, P]`` contiguous, with no copy around it; on the CPU it
    runs the plain ``make_vg``. ``thetas`` must lie on a device of the type
    the function was built for. On CUDA, ``fn.fused_launch(C)`` reports the
    launch (``fused_launch``).
    """
    device = torch.device(device)
    x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature = prepare_data(model, x, y)
    arrays = [torch.as_tensor(a, device=device).contiguous()
              for a in (x_pad, y_pad, row_mask, loc, ivar)]

    def check_device(thetas):
        if thetas.device.type != device.type:
            raise ValueError(f"thetas on {thetas.device}, but the function was built for "
                             f"device={device}")

    if device.type != "cuda":
        vg_math = make_vg(model, x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature)

        def fn(thetas):
            check_device(thetas)
            vals, grads = vg_math(thetas.to(dtype=torch.float32).T.contiguous(), *arrays)
            return vals[0], grads.T

        return fn

    n_rows = x_pad.shape[0]
    lib = load_kernel(model, fused_lanes(n_rows))
    data = fused_data(*arrays, prior_const, temperature)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    threads = {}  # a block's threads by chain count

    def launch(C):
        return fused_launch(lib, C, n_rows, sm_count)

    def fn(thetas):
        check_device(thetas)
        thetas = thetas.to(dtype=torch.float32).contiguous()  # no copy when it is already
        C = thetas.shape[0]
        if C not in threads:
            threads[C] = launch(C)["threads"]
        return fused_mlp_vg(lib, thetas, data, threads[C])

    fn.fused_launch = launch
    return fn


class FusedMLPModel:
    """A model whose ``batch_upto_grad_log_target`` for a batch of chains
    goes through the fused kernel."""

    def __init__(self, model, x, y, device="cuda"):
        self.model = model
        self.vg = make_fused_log_target_vg(model, x, y, device=device)

    def batch_upto_grad_log_target(self, thetas):
        return self.vg(thetas)
