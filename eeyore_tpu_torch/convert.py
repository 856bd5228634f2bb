"""Carry state between the JAX package and the port, as numpy arrays.

Each ``*_from_numpy`` takes array-likes (numpy arrays, or anything
``np.asarray`` accepts, such as the JAX package's arrays and NamedTuples of
them) and returns the port's tensors on ``device``; ``to_numpy`` goes back.
Flat thetas are checked against the model's ``num_params`` (any of the port's models).
"""

import numpy as np
import torch

from eeyore_tpu_torch.models.priors import IIDNormalPrior
from eeyore_tpu_torch.ops.fused_hmc import FusedHMCState
from eeyore_tpu_torch.samplers.gibbs import GibbsState
from eeyore_tpu_torch.samplers.hmc import HMCState
from eeyore_tpu_torch.samplers.mala import MALAState
from eeyore_tpu_torch.samplers.mh import MHState
from eeyore_tpu_torch.samplers.nuts import NUTSState
from eeyore_tpu_torch.tuners.dual_averaging import DualAveragingState


def _tensor(a, device, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def thetas_from_numpy(thetas, model, device="cuda", dtype=torch.float32):
    """Flat thetas [..., P] -> tensor, with P checked against the model."""
    thetas = np.asarray(thetas)
    if thetas.shape[-1] != model.num_params:
        raise ValueError(f"thetas have {thetas.shape[-1]} parameters, "
                         f"the model has {model.num_params}")
    return _tensor(thetas, device, dtype)


def prior_from_numpy(loc, scale, device="cuda", dtype=None):
    """(loc, scale) of an IID Normal prior -> ``IIDNormalPrior``."""
    return IIDNormalPrior(np.array(loc), np.array(scale), dtype=dtype, device=device)


def temperature_from_numpy(temperature):
    """A temperature (None, or a scalar array) -> None or a Python float."""
    return None if temperature is None else float(np.asarray(temperature))


def dual_averaging_state_from_numpy(state, device="cuda", dtype=None):
    return DualAveragingState(*(_tensor(getattr(state, f), device, dtype)
                                for f in DualAveragingState._fields))


def fused_hmc_state_from_numpy(state, model, device="cuda"):
    """A ``FusedHMCState`` of the JAX package (or its numpy image) -> the port's."""
    f32 = torch.float32
    return FusedHMCState(
        thetas=thetas_from_numpy(state.thetas, model, device, f32),
        target_vals=_tensor(state.target_vals, device, f32),
        grads=thetas_from_numpy(state.grads, model, device, f32),
        step=_tensor(state.step, device, f32),
        num_steps=_tensor(state.num_steps, device, torch.int32),
        tuner=dual_averaging_state_from_numpy(state.tuner, device, f32),
    )


def hmc_state_from_numpy(state, model, device="cuda", dtype=torch.float32):
    """An ``HMCState`` of the JAX package with chains stacked first (a
    vmapped state, or its numpy image) -> the port's batched ``HMCState``."""
    return HMCState(
        sample=thetas_from_numpy(state.sample, model, device, dtype),
        target_val=_tensor(state.target_val, device, dtype),
        grad_val=thetas_from_numpy(state.grad_val, model, device, dtype),
        momentum=thetas_from_numpy(state.momentum, model, device, dtype),
        hamiltonian=_tensor(state.hamiltonian, device, dtype),
        accepted=_tensor(state.accepted, device, torch.int32),
        step=_tensor(state.step, device, dtype),
        num_steps=_tensor(state.num_steps, device, torch.int32),
        tuner=dual_averaging_state_from_numpy(state.tuner, device, dtype),
    )


def mh_state_from_numpy(state, model, device="cuda", dtype=torch.float32):
    """An ``MHState`` of the JAX package with chains stacked first -> the
    port's batched ``MHState``."""
    return MHState(
        sample=thetas_from_numpy(state.sample, model, device, dtype),
        target_val=_tensor(state.target_val, device, dtype),
        accepted=_tensor(state.accepted, device, torch.int32),
    )


def mala_state_from_numpy(state, model, device="cuda", dtype=torch.float32):
    """A ``MALAState`` of the JAX package with chains stacked first -> the
    port's batched ``MALAState``."""
    return MALAState(
        sample=thetas_from_numpy(state.sample, model, device, dtype),
        target_val=_tensor(state.target_val, device, dtype),
        grad_val=thetas_from_numpy(state.grad_val, model, device, dtype),
        accepted=_tensor(state.accepted, device, torch.int32),
    )


def gibbs_state_from_numpy(state, model, device="cuda", dtype=torch.float32):
    """A ``GibbsState`` of the JAX package with chains stacked first -> the
    port's batched ``GibbsState`` (``accepted`` [C, num_sub_blocks])."""
    return GibbsState(
        sample=thetas_from_numpy(state.sample, model, device, dtype),
        target_val=_tensor(state.target_val, device, dtype),
        accepted=_tensor(state.accepted, device, torch.int32),
    )


def nuts_state_from_numpy(state, model, device="cuda", dtype=torch.float32):
    """A ``NUTSState`` of the JAX package with chains stacked first -> the
    port's batched ``NUTSState``. ``to_numpy`` goes back, field for field, to
    the JAX ``NUTSState``'s arrays."""
    i32 = torch.int32
    return NUTSState(
        sample=thetas_from_numpy(state.sample, model, device, dtype),
        target_val=_tensor(state.target_val, device, dtype),
        grad_val=thetas_from_numpy(state.grad_val, model, device, dtype),
        accepted=_tensor(state.accepted, device, i32),
        accept_stat=_tensor(state.accept_stat, device, dtype),
        depth=_tensor(state.depth, device, i32),
        num_leapfrogs=_tensor(state.num_leapfrogs, device, i32),
        divergent=_tensor(state.divergent, device, i32),
        step=_tensor(state.step, device, dtype),
        inv_mass=thetas_from_numpy(state.inv_mass, model, device, dtype),
        wf_mean=thetas_from_numpy(state.wf_mean, model, device, dtype),
        wf_m2=thetas_from_numpy(state.wf_m2, model, device, dtype),
        wf_n=_tensor(state.wf_n, device, i32),
        tuner=dual_averaging_state_from_numpy(state.tuner, device, dtype),
    )


def to_numpy(obj):
    """Tensor -> numpy array; NamedTuple of tensors -> the same NamedTuple of
    numpy arrays; None stays None."""
    if obj is None:
        return None
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)
