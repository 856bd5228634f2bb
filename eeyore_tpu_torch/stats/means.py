"""Streaming moment updates and running means.

Counterpart of ``eeyore_tpu/stats/means.py``, on tensors.
"""

import torch


def recursive_mean(last_mean, n, x, offset=0):
    """Streaming mean update: mean_k = ((k-1) mean_{k-1} + x) / k with
    k = n - offset."""
    k = n - offset
    return ((k - 1) * last_mean + x) / k


def recursive_cov(last_cov, last_mean, second_last_mean, n, x, offset=0):
    """Streaming covariance update: with k = n - offset,
    cov_k = ((k-1) cov_{k-1} + x x' - (k+1) m_k m_k' + k m_{k-1} m_{k-1}') / k."""
    k = n - offset
    return (
        (k - 1) * last_cov
        + torch.outer(x, x)
        - (k + 1) * torch.outer(last_mean, last_mean)
        + k * torch.outer(second_last_mean, second_last_mean)
    ) / k


def running_mean(x, axis=0):
    """Cumulative running mean along an axis."""
    x = torch.as_tensor(x)
    counts = torch.arange(1, x.shape[axis] + 1, dtype=x.dtype, device=x.device)
    shape = [1] * x.dim()
    shape[axis] = -1
    return torch.cumsum(x, dim=axis) / counts.reshape(shape)
