"""Positive-definiteness guards, in float64 PyTorch (they back the post-hoc
diagnostics, not the sampling path).

Counterpart of ``eeyore_tpu/linalg/pd.py``: ``is_pos_def`` is symmetric and
Cholesky succeeds; ``nearest_pd`` is Higham's projection with an eigenvalue
jitter loop.
"""

import torch


def _f64(a):
    return torch.as_tensor(a, dtype=torch.float64)


def is_pos_def(a):
    a = torch.as_tensor(a)
    if not torch.equal(a, a.T):
        return False
    return bool(torch.linalg.cholesky_ex(a).info == 0)


def _spacing(x):
    """Distance from ``x`` (> 0) to the next larger float64, as np.spacing."""
    x = _f64(x)
    return torch.nextafter(x, torch.tensor(float("inf"), dtype=x.dtype, device=x.device)) - x


def nearest_pd(a, f=_spacing):
    """Nearest positive-definite matrix (Higham 1988): symmetrize, replace by
    the PSD polar factor average, then add diagonal jitter until Cholesky
    succeeds."""
    a = _f64(a)
    b = (a + a.T) / 2
    _, s, vt = torch.linalg.svd(b)
    h = vt.T @ torch.diag(s) @ vt
    a2 = (b + h) / 2
    a3 = (a2 + a2.T) / 2

    if is_pos_def(a3):
        return a3

    spacing = f(torch.linalg.norm(a))
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    k = 1
    while not is_pos_def(a3):
        mineig = torch.min(torch.linalg.eigvals(a3).real)
        a3 = a3 + eye * (-mineig * k**2 + spacing)
        k += 1
    return a3
