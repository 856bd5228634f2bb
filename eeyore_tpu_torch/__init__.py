"""eeyore_tpu_torch: the PyTorch and CUDA port of eeyore_tpu.

The same subpackage layout and public names as ``eeyore_tpu``, in PyTorch
idiom: models are functions of a flat theta over tensors on an explicit
``device`` (``"cuda"`` unless the caller asks otherwise), randomness comes
from explicit ``torch.Generator``s, and every Pallas kernel on a ported path
is a CUDA kernel written by hand for Hopper (``sm_90a``) under ``ops/csrc/``,
with its plain PyTorch version beside it. The JAX package is the reference
the port is tested against; the port imports nothing from it.
"""

__version__ = "0.1.0"

from eeyore_tpu_torch import (
    chains, convert, datasets, integrators, kernels, linalg, models, ops, parallel, plots, samplers,
    stats, tuners, utils,
)
