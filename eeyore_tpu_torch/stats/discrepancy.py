"""Kernel maximum-mean discrepancy between two sample sets.

Counterpart of ``eeyore_tpu/stats/discrepancy.py``: the Gram matrices come
from one pairwise-distance computation each (``kernels/function_kernels.py``).
"""

import torch


def _rows(x):
    x = torch.as_tensor(x)
    return x.reshape(1, -1) if x.dim() < 2 else x


def squared_mmd(x1, x2, kernel, biased=True):
    x1, x2 = _rows(x1), _rows(x2)
    n1, n2 = x1.shape[0], x2.shape[0]

    k11 = kernel.gram(x1, x1)
    k22 = kernel.gram(x2, x2)
    k12 = kernel.gram(x1, x2)

    if biased:
        return (
            torch.sum(k11) / (n1**2)
            + torch.sum(k22) / (n2**2)
            - 2 * torch.sum(k12) / (n1 * n2)
        )
    return (
        (torch.sum(k11) - torch.trace(k11)) / (n1 * (n1 - 1))
        + (torch.sum(k22) - torch.trace(k22)) / (n2 * (n2 - 1))
        - 2 * torch.sum(k12) / (n1 * n2)
    )


def mmd(x1, x2, kernel):
    return torch.sqrt(squared_mmd(x1, x2, kernel, biased=True))
