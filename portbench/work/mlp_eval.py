"""Float32 operations of one value-and-gradient evaluation of a sigmoid MLP
for one chain over a dataset, from the configuration's widths and the
data's values: the work the inputs need, whatever computes it.

A multiply-add counts 2, any other arithmetic operation 1, and an exp, log,
log1p or reciprocal 1. A unit's pre-activation is a multiply-add per input
(the bias is the sum's start); a first-layer product with an input of 0 is
no work and with an input of 1 an add, in the forward pass and in the
weight gradient alike. A sigmoid is exp, add, reciprocal (3). The
multiclass head: max, shifts, exps, sum, log, lse, picked logit (4k + 1),
its deltas a reciprocal, k products and k subtractions (2k + 1). The binary
head per output: softplus (abs, exp, log1p, max, add), y z and the
subtraction (7), its delta the sigmoid from the same exp and a subtraction
(5). Each row's log-likelihood is added once (1). Backward: a weight
gradient is a multiply-add per weight and row, a bias gradient an add per
unit and row, a hidden unit's delta a multiply-add per outgoing weight and
a(1 - a) times it (3). The N(mu, s) prior: the value 2P + 2, the gradient
2P, the sum of the two terms 1.
"""

import numpy as np


def _input_ops(x):
    """Per row, the first-layer work of one unit's inputs: 0 for a 0, 1 for
    a 1, 2 otherwise, summed over the inputs."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(x == 0.0, 0, np.where(x == 1.0, 1, 2)).sum(axis=1)


def num_params(dims):
    return sum(dims[l] * dims[l + 1] + dims[l + 1] for l in range(len(dims) - 1))


def eval_ops(config, x):
    """Operations of one evaluation (value and gradient) for one chain."""
    dims = config["dims"]
    L = len(dims) - 1
    k = dims[-1]
    first = _input_ops(x)                                  # [N]
    rows = x.shape[0]
    forward = dims[1] * first.sum() + rows * sum(2 * dims[l] * dims[l + 1] for l in range(1, L))
    hidden = sum(dims[1:-1])
    per_row = 3 * hidden + 1
    if config["loss"] == "multiclass_classification":
        per_row += (4 * k + 1) + (2 * k + 1)
    else:
        per_row += 12 * k
    weight_grads = dims[1] * first.sum() + rows * sum(2 * dims[l] * dims[l + 1]
                                                      for l in range(1, L))
    bias_grads = rows * sum(dims[1:])
    deltas = rows * sum(2 * dims[l] * dims[l + 1] + 3 * dims[l] for l in range(1, L))
    P = num_params(dims)
    return int(forward + rows * per_row + weight_grads + bias_grads + deltas + 4 * P + 3)


def io_bytes(config, chains, kept, extra_outputs_per_chain, data_rows):
    """Bytes read and written once: theta0 and the data in; the samples, the
    final states and ``extra_outputs_per_chain`` floats a chain out."""
    P = num_params(config["dims"])
    data = data_rows * (config["dims"][0] + config["dims"][-1])
    return 4 * (chains * P + data + kept * chains * P + chains * P
                + extra_outputs_per_chain * chains)
