from eeyore_tpu_torch.kernels.function_kernels import (
    HomogeneousKernel,
    IsoSEKernel,
    PeriodicKernel,
    RQKernel,
)
from eeyore_tpu_torch.kernels.proposal_kernels import (
    DEMCKernel,
    MultivariateNormalKernel,
    NormalKernel,
)
