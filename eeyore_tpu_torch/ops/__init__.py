from eeyore_tpu_torch.ops.fused_hmc import FusedHMC, FusedHMCState
from eeyore_tpu_torch.ops.fused_mlp import (
    FusedMLPModel,
    launch_counts,
    make_fused_log_target_vg,
)
from eeyore_tpu_torch.ops.mlp_math import extract_arch, make_vg, prepare_data
from eeyore_tpu_torch.ops.resident_hmc import make_resident_hmc
from eeyore_tpu_torch.ops.mlp_dense import make_vg_dense, stack_chains, unstack_chains
from eeyore_tpu_torch.ops.resident_hmc_dense import make_resident_hmc_dense
from eeyore_tpu_torch.ops.resident_walk import make_resident_mala, make_resident_mh
from eeyore_tpu_torch.ops.resident_walk_dense import (
    make_resident_mala_dense,
    make_resident_mh_dense,
)
