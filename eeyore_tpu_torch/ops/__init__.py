from eeyore_tpu_torch.ops.fused_hmc import FusedHMC, FusedHMCState
from eeyore_tpu_torch.ops.fused_mlp import (
    FusedMLPModel,
    launch_counts,
    make_fused_log_target_vg,
)
from eeyore_tpu_torch.ops.mlp_math import extract_arch, make_vg, prepare_data
from eeyore_tpu_torch.ops.resident_hmc import make_resident_hmc
