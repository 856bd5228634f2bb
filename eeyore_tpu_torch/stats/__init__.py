from eeyore_tpu_torch.stats.cov import cor, cor_from_cov, cov
from eeyore_tpu_torch.stats.ess import multi_ess
from eeyore_tpu_torch.stats.mc_cov import inse_mc_cov, mc_cor, mc_cov, mc_se, mc_se_from_cov
from eeyore_tpu_torch.stats.rhat import multi_rhat
