from eeyore_tpu_torch.kernels.proposal_kernels import (
    DEMCKernel,
    MultivariateNormalKernel,
    NormalKernel,
)
