"""Distance-based function kernels (used by the MMD discrepancy).

Counterpart of ``eeyore_tpu/kernels/function_kernels.py``: ``gram`` computes
the Gram matrix [n1, n2] from one pairwise-distance computation,
||a - b||^2 = |a|^2 + |b|^2 - 2 a.b, clamped at 0.
"""

import torch


def _rows(x):
    x = torch.as_tensor(x)
    return x.reshape(1, -1) if x.dim() < 2 else x


class HomogeneousKernel:
    """Base for kernels k(x1, x2) = f(||x1 - x2||)."""

    def k(self, x1, x2):
        """Kernel value between two points."""
        return self._from_sqdist(torch.sum((torch.as_tensor(x1) - torch.as_tensor(x2)) ** 2))

    def _from_sqdist(self, sqdist):
        raise NotImplementedError

    def gram(self, x1, x2):
        x1, x2 = _rows(x1), _rows(x2)
        sq1 = torch.sum(x1 * x1, dim=1, keepdim=True)
        sq2 = torch.sum(x2 * x2, dim=1, keepdim=True)
        sqdist = torch.clamp(sq1 + sq2.T - 2.0 * (x1 @ x2.T), min=0.0)
        return self._from_sqdist(sqdist)

    def symm_K(self, x):
        return self.gram(x, x)

    def K(self, x1, x2):
        return self.gram(x1, x2)

    def sum_symm_K(self, x, include_diag=True):
        g = self.gram(x, x)
        total = torch.sum(g)
        return total if include_diag else total - torch.trace(g)

    def sum_K(self, x1, x2):
        return torch.sum(self.gram(x1, x2))


class IsoSEKernel(HomogeneousKernel):
    """Isotropic squared exponential: scale * exp(-d^2 / (2 l))."""

    def __init__(self, scale=1.0, l=1.0):
        self.scale = scale  # squared amplitude
        self.l = l  # squared lengthscale

    def _from_sqdist(self, sqdist):
        return self.scale * torch.exp(-sqdist / (2.0 * self.l))


class PeriodicKernel(HomogeneousKernel):
    """scale * exp(-2 sin^2(d / p) / l)."""

    def __init__(self, scale=1.0, l=1.0, p=2.0):
        self.scale = scale
        self.l = l
        self.p = p

    def _from_sqdist(self, sqdist):
        d = torch.sqrt(sqdist)
        return self.scale * torch.exp(-2.0 * torch.sin(d / self.p) ** 2 / self.l)


class RQKernel(HomogeneousKernel):
    """Rational quadratic: scale * (1 + d^2 / (2 a l))^(-a)."""

    def __init__(self, scale=1.0, l=1.0, a=1.0):
        self.scale = scale
        self.l = l
        self.a = a

    def _from_sqdist(self, sqdist):
        return self.scale * (1.0 + sqdist / (2.0 * self.a * self.l)) ** (-self.a)
