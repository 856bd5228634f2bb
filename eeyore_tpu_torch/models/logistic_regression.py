"""Bayesian logistic regression: one linear layer and an optional activation.

Counterpart of ``eeyore_tpu/models/logistic_regression.py``. Flat theta
layout: the row-major weight (output_size, input_size), then the bias. The
kernels take it as a one-layer MLP (``ops/mlp_math.py::extract_arch``).
"""

import torch

from eeyore_tpu_torch.models.mlp import float32_matmul_precision, sigmoid
from eeyore_tpu_torch.models.model import BayesianModel
from eeyore_tpu_torch.models.priors import IIDNormalPrior


class Hyperparameters:
    def __init__(self, input_size=1, output_size=1, bias=True, activation="default"):
        self.input_size = input_size
        self.output_size = output_size
        self.bias = bias
        self.activation = sigmoid if activation == "default" else activation


class LogisticRegression(BayesianModel):
    """``forward`` takes ``theta [..., P]`` and ``x [n, input_size]``; its
    matmul runs at ``matmul_precision`` (default "highest": full f32, never
    TF32), as ``MLP.forward``'s do."""

    def __init__(self, loss, hparams=None, prior=None, temperature=None, dtype=None,
                 device="cuda", matmul_precision="highest"):
        super().__init__(loss, prior=prior, temperature=temperature, dtype=dtype, device=device)
        self.matmul_precision = matmul_precision
        self.hp = hparams or Hyperparameters()
        self.num_params = self.hp.input_size * self.hp.output_size + (
            self.hp.output_size if self.hp.bias else 0
        )
        self.prior = prior or self.default_prior()

    def default_prior(self):
        return IIDNormalPrior.standard(self.num_params, dtype=self.dtype, device=self.device)

    def forward(self, theta, x):
        """x [n, input_size] -> [..., n, output_size] for theta [..., P]."""
        w_size = self.hp.input_size * self.hp.output_size
        w = theta[..., :w_size].reshape(theta.shape[:-1] + (self.hp.output_size,
                                                           self.hp.input_size))
        with float32_matmul_precision(self.matmul_precision):
            h = torch.matmul(x, w.transpose(-1, -2))
        if self.hp.bias:
            h = h + theta[..., None, w_size:]
        if self.hp.activation is not None:
            h = self.hp.activation(h)
        return h
