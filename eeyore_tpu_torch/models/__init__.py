from eeyore_tpu_torch.models import logistic_regression, mlp
from eeyore_tpu_torch.models.logistic_regression import LogisticRegression
from eeyore_tpu_torch.models.losses import (
    binary_classification_loss,
    binary_cross_entropy,
    cross_entropy,
    loss_functions,
    multiclass_classification_loss,
)
from eeyore_tpu_torch.models.mlp import MLP
from eeyore_tpu_torch.models.model import BayesianModel, DistributionModel, LogTargetModel
from eeyore_tpu_torch.models.priors import IIDNormalPrior
