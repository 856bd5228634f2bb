from eeyore_tpu_torch.samplers.base import TransitionKernel
from eeyore_tpu_torch.samplers.gibbs import Gibbs, GibbsState
from eeyore_tpu_torch.samplers.hmc import HMC, HMCState
from eeyore_tpu_torch.samplers.mala import MALA, MALAState
from eeyore_tpu_torch.samplers.mh import MetropolisHastings, MHState
from eeyore_tpu_torch.samplers.nuts import NUTS, NUTSState, choose_max_depth
from eeyore_tpu_torch.samplers.population import PopulationKernel, sample_population
from eeyore_tpu_torch.samplers.power_posterior import (
    PowerPosteriorSampler,
    categorical_swap_probs,
    default_temperatures,
)
from eeyore_tpu_torch.samplers.runner import sample_chain, sample_chains
from eeyore_tpu_torch.samplers.smc import SMCSampler, SMCState, systematic_resample_indices
