"""Loss functions with the reference's numerical semantics.

Counterpart of ``eeyore_tpu/models/losses.py``. The JAX losses reduce one
theta's ``[n, k]`` predictions; here a leading batch of chains is allowed,
so ``sum`` and ``mean`` reduce the trailing ``[n, k]`` dimensions and keep
the batch: ``[..., n, k] -> [...]``.
"""

import torch


def _reduce(loss, reduction):
    dims = tuple(range(-min(loss.dim(), 2), 0))
    if reduction == "mean":
        return torch.mean(loss, dim=dims)
    elif reduction == "sum":
        return torch.sum(loss, dim=dims)
    raise ValueError(f"unknown reduction {reduction!r}")


def binary_cross_entropy(x, y, reduction="mean"):
    """BCE on probabilities: -(log(x) y + log(1-x)(1-y)), with 0*log(0) = 0.

    In f32 the sigmoid saturates to exactly 1.0 for z > ~17, and the naive
    product then gives 0 * log(0) = NaN for a correctly classified point.
    As in the JAX package, the untaken branch's argument is replaced too, so
    that its -inf never reaches the gradient as 0 * inf. A point saturated on
    the wrong side still contributes -inf.
    """
    x_pos = torch.where(y > 0, x, torch.ones_like(x))
    x_neg = torch.where(y < 1, x, torch.zeros_like(x))
    loss = -(y * torch.log(x_pos) + (1 - y) * torch.log1p(-x_neg))
    return _reduce(loss, reduction)


def cross_entropy(logits, y_onehot, reduction="sum"):
    """Softmax cross-entropy against one-hot labels:
    sum_i [logsumexp(logits_i) - logits_i[class_i]]."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.sum(logits * y_onehot, dim=-1)
    loss = (lse - picked)[..., None]
    return _reduce(loss, reduction)


def binary_classification_loss(x, y):
    return binary_cross_entropy(x, y, reduction="sum")


def multiclass_classification_loss(logits, y_onehot):
    return cross_entropy(logits, y_onehot, reduction="sum")


loss_functions = {
    "binary_classification": binary_classification_loss,
    "multiclass_classification": multiclass_classification_loss,
}
