from eeyore_tpu_torch.samplers.base import TransitionKernel
from eeyore_tpu_torch.samplers.gibbs import Gibbs, GibbsState
from eeyore_tpu_torch.samplers.hmc import HMC, HMCState
from eeyore_tpu_torch.samplers.mala import MALA, MALAState
from eeyore_tpu_torch.samplers.mh import MetropolisHastings, MHState
from eeyore_tpu_torch.samplers.runner import sample_chain, sample_chains
