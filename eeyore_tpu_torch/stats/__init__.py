from eeyore_tpu_torch.stats.cov import cor, cor_from_cov, cov
from eeyore_tpu_torch.stats.discrepancy import mmd, squared_mmd
from eeyore_tpu_torch.stats.ess import multi_ess
from eeyore_tpu_torch.stats.mc_cov import inse_mc_cov, mc_cor, mc_cov, mc_se, mc_se_from_cov
from eeyore_tpu_torch.stats.means import recursive_cov, recursive_mean, running_mean
from eeyore_tpu_torch.stats.metrics import softabs
from eeyore_tpu_torch.stats.random import choose, choose_from_subset
from eeyore_tpu_torch.stats.rhat import multi_rhat

# the loss, exported here as in the JAX package
from eeyore_tpu_torch.models.losses import binary_cross_entropy
