"""Fused log-posterior and gradient for a population of MLP chains.

Counterpart of ``eeyore_tpu/ops/fused_mlp.py``. ``make_fused_log_target_vg``
returns ``fn(thetas [C, P]) -> (values [C], grads [C, P])``, the tempered log
posterior and its gradient for every chain in one launch of the CUDA kernel
``ops/csrc/fused_mlp_vg.cu``. Inside, theta is laid out ``[P, C]`` with the
chains minor, as the TPU kernel has it, so that the threads of a warp, one
chain each, read consecutive addresses. Any ``C`` works: the TPU's
``chain_block`` tiling has no counterpart here.

Built for ``device="cpu"``, the function runs the plain version,
``mlp_math.make_vg``; built for a CUDA device, it launches the kernel on every
call, and the kernel's wrapper ``fused_mlp_vg`` raises on anything but CUDA
tensors. There is no fallback from one to the other.
"""

import ctypes

import torch

from eeyore_tpu_torch.ops import _build
from eeyore_tpu_torch.ops.mlp_math import extract_arch, make_vg, prepare_data

KERNEL = "fused_mlp_vg"

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


def load_kernel(model):
    """Build (at first use) and load the fused kernel for ``model``'s
    architecture, which the kernel takes as compile-time constants."""
    dims, _, loss_kind, _ = extract_arch(model)
    ce = int(loss_kind == "ce")
    tag, defines = arch_defines(model)
    name = f"{KERNEL}_{tag}"
    lib = _build.load_library(name, "fused_mlp_vg.cu", defines)
    lib.fused_mlp_vg_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 3)
    lib.fused_mlp_vg_launch.restype = ctypes.c_int
    lib.fused_mlp_vg_error_string.argtypes = [ctypes.c_int]
    lib.fused_mlp_vg_error_string.restype = ctypes.c_char_p
    lib.fused_mlp_vg_arch.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.fused_mlp_vg_arch.restype = ctypes.c_int
    lib.fused_mlp_vg_resources.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.fused_mlp_vg_resources.restype = ctypes.c_int

    arch = (ctypes.c_int * 4)()
    lib.fused_mlp_vg_arch(arch)
    expected = [model.num_params, dims[0], dims[-1], ce]
    if list(arch) != expected:
        raise RuntimeError(f"{name}: library built for {list(arch)}, model needs {expected}")
    return lib


def kernel_resources(lib):
    """Registers per thread and local-memory bytes per thread (spills) of
    the loaded kernel, as the CUDA runtime reports them."""
    out = (ctypes.c_int * 2)()
    err = lib.fused_mlp_vg_resources(out)
    if err != 0:
        raise RuntimeError(f"fused_mlp_vg: {lib.fused_mlp_vg_error_string(err).decode()}")
    return {"registers": out[0], "local_bytes": out[1]}


def fused_mlp_vg(lib, theta, x, y, mask, loc, ivar, prior_const, temperature):
    """Launch the kernel: theta [P, C] -> (val [1, C], grad [P, C]), f32 on
    one CUDA device, on the current stream."""
    P, C = theta.shape
    n_rows = x.shape[0]
    for t in (theta, x, y, mask, loc, ivar):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_mlp_vg takes contiguous float32 CUDA tensors")
        if t.device != theta.device:
            raise ValueError("fused_mlp_vg takes its tensors on one device")
    if y.shape[0] != n_rows or mask.numel() != n_rows or loc.numel() != P or ivar.numel() != P:
        raise ValueError("fused_mlp_vg: inconsistent shapes")
    if C == 0:
        raise ValueError("fused_mlp_vg needs at least one chain")
    val = torch.empty((1, C), dtype=torch.float32, device=theta.device)
    grad = torch.empty((P, C), dtype=torch.float32, device=theta.device)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    err = lib.fused_mlp_vg_launch(
        theta.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(), loc.data_ptr(),
        ivar.data_ptr(), prior_const, temperature, n_rows, C, val.data_ptr(),
        grad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_vg launch failed: {lib.fused_mlp_vg_error_string(err)}")
    launch_counts[KERNEL] += 1
    return val, grad


def make_fused_log_target_vg(model, x, y, device="cuda"):
    """Build ``fn(thetas [C, P]) -> (values [C], grads [C, P])`` in float32.

    ``model``: an ``eeyore_tpu_torch.models.MLP`` with an ``IIDNormalPrior``
    and the registered BCE or CE loss. On a CUDA ``device`` every call
    launches the hand-written kernel; on the CPU it runs the plain
    ``make_vg``. ``thetas`` must lie on a device of the type the function was
    built for.
    """
    device = torch.device(device)
    x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature = prepare_data(model, x, y)
    vg_math = make_vg(model, x_pad, y_pad, row_mask, loc, ivar, prior_const, temperature)
    arrays = [torch.as_tensor(a, device=device).contiguous()
              for a in (x_pad, y_pad, row_mask, loc, ivar)]
    lib = load_kernel(model) if device.type == "cuda" else None

    def fn(thetas):
        if thetas.device.type != device.type:
            raise ValueError(f"thetas on {thetas.device}, but the function was built for "
                             f"device={device}")
        theta_t = thetas.to(dtype=torch.float32).T.contiguous()  # [P, C]
        if lib is None:
            vals, grads = vg_math(theta_t, *arrays)
        else:
            vals, grads = fused_mlp_vg(lib, theta_t, *arrays, prior_const, temperature)
        return vals[0], grads.T

    return fn


class FusedMLPModel:
    """A model whose ``batch_upto_grad_log_target`` for a batch of chains
    goes through the fused kernel."""

    def __init__(self, model, x, y, device="cuda"):
        self.model = model
        self.vg = make_fused_log_target_vg(model, x, y, device=device)

    def batch_upto_grad_log_target(self, thetas):
        return self.vg(thetas)
