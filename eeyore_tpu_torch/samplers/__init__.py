from eeyore_tpu_torch.samplers.am import AM, AMState
from eeyore_tpu_torch.samplers.base import TransitionKernel
from eeyore_tpu_torch.samplers.demc import DEMC, DEMCState
from eeyore_tpu_torch.samplers.gibbs import Gibbs, GibbsState
from eeyore_tpu_torch.samplers.harness import SamplerHarness
from eeyore_tpu_torch.samplers.hmc import HMC, HMCState
from eeyore_tpu_torch.samplers.mala import MALA, MALAState
from eeyore_tpu_torch.samplers.mh import MetropolisHastings, MHState
from eeyore_tpu_torch.samplers.monitor import summarize_run
from eeyore_tpu_torch.samplers.nuts import NUTS, NUTSState, choose_max_depth
from eeyore_tpu_torch.samplers.population import PopulationKernel, sample_population
from eeyore_tpu_torch.samplers.ram import RAM, RAMState
from eeyore_tpu_torch.samplers.power_posterior import (
    PowerPosteriorSampler,
    categorical_swap_probs,
    default_temperatures,
)
from eeyore_tpu_torch.samplers.runner import sample_chain, sample_chains
from eeyore_tpu_torch.samplers.smc import SMCSampler, SMCState, systematic_resample_indices
