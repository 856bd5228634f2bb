from eeyore_tpu_torch.parallel.mesh import (
    chain_mesh,
    chain_sharding,
    initialize_distributed,
    ladder_mesh,
)
from eeyore_tpu_torch.parallel.sharded import (
    global_log_ess,
    global_logsumexp,
    run_power_posterior_sharded,
    run_resident_hmc_sharded,
    run_resident_tempering_sharded,
    run_smc_sharded,
    sample_chains_sharded,
)
