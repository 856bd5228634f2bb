"""SoftAbs metric: the eigenvalue-softened positive-definite form of a
symmetric matrix, softabs(H, a) = Q diag(lambda / tanh(a lambda)) Q^T.

Counterpart of ``eeyore_tpu/stats/metrics.py``.
"""

import torch


def softabs(hessian, a=1000.0):
    """SoftAbs of ``hessian [..., P, P]``, each matrix of a batch alone."""
    l, q = torch.linalg.eigh(hessian)
    softened = l / torch.tanh(a * l)
    return (q * softened.unsqueeze(-2)) @ q.mT
