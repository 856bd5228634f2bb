"""Monte-Carlo covariance estimators for correlated MCMC samples, in float64
PyTorch.

Counterpart of ``eeyore_tpu/stats/mc_cov.py``. ``inse_mc_cov`` is the
initial-sequence (INSE) multivariate estimator of Dai & Jones 2017, with the
lag-pair matrices from the same vectorised provider:

- the estimator only consumes ``Gamma_m = gamma_{2m} + gamma_{2m+1}``; with
  ``u[i] = x[i] + x[i+1]``, ``Gamma_m = x[:n-2m].T @ u[2m:] / n``, one
  product per m;
- shallow lags come in geometrically growing batches from one batched
  product over strided windows;
- once the stopping rule runs past ``_FFT_SWITCH_M`` pair-lags on a long
  chain, all remaining ``Gamma_m`` come from one decimated FFT
  cross-correlation pass (``torch.fft``, where the JAX package uses
  scipy's or numpy's FFT).

Contract: Sigma grows by 2 Gamma_m until it first becomes positive definite,
then until its determinant stops increasing; ``adjust=True`` subtracts the
positive-eigenvalue parts of the later Gammas; RuntimeError('Not enough
samples') if no PD point is found in m < floor(n/2).
"""

import torch

from eeyore_tpu_torch.linalg import is_pos_def
from eeyore_tpu_torch.stats.cov import cor_from_cov, cov

_FFT_SWITCH_M = 48
_FFT_MIN_N = 4096


def _lag_autocov(x_ctr, lag):
    """gamma_lag = (1/n) sum_i x_ctr[i] outer x_ctr[i+lag]; one product."""
    n, p = x_ctr.shape
    if lag >= n:
        return x_ctr.new_zeros((p, p))
    return (x_ctr[: n - lag].T @ x_ctr[lag:]) / n


class _GammaProvider:
    """Lazy supplier of Gamma_m = gamma_{2m} + gamma_{2m+1} (unsymmetrized;
    the caller symmetrizes) for a centered chain x_ctr [n, p]."""

    def __init__(self, x_ctr):
        self.x = x_ctr.contiguous()
        n, p = self.x.shape
        self.n, self.p = n, p
        # pair-sum u[i] = x[i] + x[i+1], u[n-1] = x[n-1]
        self.u = torch.cat([self.x[:-1] + self.x[1:], self.x[n - 1:]])
        self._blocks = {}  # m0 -> [B, p, p] batch starting at pair-lag m0
        self._block_starts = []
        self._next_m = 0
        self._next_B = 8
        self._fft_all = None  # [m_cap, p, p] once the FFT pass has run

    def gamma(self, m):
        """Gamma_m (pair-sum, unsymmetrized). m < n//2."""
        if self._fft_all is not None and m < self._fft_all.shape[0]:
            return self._fft_all[m]
        while m >= self._next_m and self._fft_all is None:
            if self.n >= _FFT_MIN_N and self._next_m >= _FFT_SWITCH_M:
                self._fft_all = self._fft_gammas(self._cap_for(m))
                return self._fft_all[m]
            self._direct_block(self._next_m, self._next_B)
            self._next_m += self._next_B
            self._next_B = min(2 * self._next_B, 256)
        if self._fft_all is not None:  # ran past the capped FFT pass: redo
            self._fft_all = self._fft_gammas(self._cap_for(m))
            return self._fft_all[m]
        i = max(k for k, m0 in enumerate(self._block_starts) if m0 <= m)
        m0 = self._block_starts[i]
        return self._blocks[m0][m - m0]

    def _cap_for(self, m):
        return min(self.n // 2, max(4096, 8 * (m + 1)))

    def _direct_block(self, m0, B):
        """Gamma_{m0}..Gamma_{m0+B-1} with one batched product over strided
        windows of the zero-padded pair-sum sequence."""
        n, p = self.n, self.p
        rows = n - 2 * m0
        if rows <= 0:
            self._blocks[m0] = self.x.new_zeros((B, p, p))
            self._block_starts.append(m0)
            return
        # window m0+k starts at row 2k of u[2*m0:]; rows past the valid
        # range of deeper lags read zeros
        z = torch.cat([self.u[2 * m0:], self.x.new_zeros((2 * (B - 1), p))]).contiguous()
        w = torch.as_strided(z, (B, rows, p), (2 * p, p, 1))
        self._blocks[m0] = torch.matmul(self.x[:rows].T, w) / n
        self._block_starts.append(m0)

    def _fft_gammas(self, m_cap):
        """Gamma_m for m in [0, m_cap) by decimated FFT cross-correlation:
        Gamma_m[a,b] = sum_j xe[j,a] ue[j+m,b] + sum_j xo[j,a] uo[j+m,b]
        with xe/xo (ue/uo) the even/odd-index rows; the symmetrized spectrum
        T_ab + T_ba is inverted directly, so the caller's (G + G.T)/2 is the
        identity."""
        n, p = self.n, self.p
        xe, xo = self.x[0::2], self.x[1::2]
        ue, uo = self.u[0::2], self.u[1::2]
        ne = xe.shape[0]
        # circular correlation is alias-free for lags < m_cap once
        # nfft >= ne + m_cap
        nfft = 1 << (ne + m_cap - 1).bit_length()
        Fxe, Fxo = torch.fft.rfft(xe, nfft, dim=0), torch.fft.rfft(xo, nfft, dim=0)
        Fue, Fuo = torch.fft.rfft(ue, nfft, dim=0), torch.fft.rfft(uo, nfft, dim=0)
        cFxe, cFxo = Fxe.conj(), Fxo.conj()
        out = self.x.new_empty((m_cap, p, p))
        # chunk the row axis 'a' so the spectrum temporaries stay ~100MB
        ka = max(1, min(p, int(4e6 / max(nfft * p, 1)) or 1))
        scale = 1.0 / (2.0 * n)
        for a0 in range(0, p, ka):
            a1 = min(p, a0 + ka)
            S = (cFxe[:, a0:a1, None] * Fue[:, None, :]
                 + cFxo[:, a0:a1, None] * Fuo[:, None, :]
                 + Fue[:, a0:a1, None] * cFxe[:, None, :]
                 + Fuo[:, a0:a1, None] * cFxo[:, None, :])
            c = torch.fft.irfft(S.reshape(S.shape[0], -1), nfft, dim=0)[:m_cap]
            out[:, a0:a1, :] = c.reshape(m_cap, a1 - a0, p) * scale
        return out


def inse_mc_cov(x, adjust=False):
    x = torch.as_tensor(x, dtype=torch.float64)
    x_ctr = x - x.mean(dim=0)
    n, p = x.shape

    ub = n // 2
    sn = ub

    gamadj = x.new_zeros((p, p)) if adjust else None

    provider = _GammaProvider(x_ctr)

    def gamma_sym(m):
        g = provider.gamma(m)
        return (g + g.T) / 2

    sig = None
    for m in range(ub):
        gam = gamma_sym(m)
        if m == 0:
            sig = -_lag_autocov(x_ctr, 0) + 2 * gam
        else:
            sig = sig + 2 * gam
        if is_pos_def(sig):
            sn = m
            break

    if sn > ub - 1:
        raise RuntimeError("Not enough samples")

    last_det = torch.linalg.det(sig)

    for m in range(sn + 1, ub):
        gam = gamma_sym(m)
        sig1 = sig + 2 * gam
        current_det = torch.linalg.det(sig1)
        if current_det <= last_det:
            break
        sig = sig1
        last_det = current_det

        if adjust:
            eigenvals, eigenvecs = torch.linalg.eigh(gam)
            eigenvals = torch.where(eigenvals > 0, 0.0, eigenvals)
            gamadj = gamadj - eigenvecs @ torch.diag(eigenvals) @ eigenvecs.T

    if adjust:
        sig = sig + 2 * gamadj

    return sig


def mc_cov(x, method="inse", adjust=False, rowvar=False):
    if method == "inse":
        return inse_mc_cov(x, adjust=adjust)
    elif method == "iid":
        return cov(x, rowvar=rowvar)
    raise ValueError(f"The method can be inse or iid, {method} was given")


def mc_se_from_cov(mc_cov_mat):
    """sqrt(diag(mc_cov)) (the square root of the asymptotic variance, not
    divided by n, as in the reference)."""
    return torch.sqrt(torch.diag(torch.as_tensor(mc_cov_mat, dtype=torch.float64)))


def mc_se(x, method="inse", adjust=False, rowvar=False):
    return mc_se_from_cov(mc_cov(x, method=method, adjust=adjust, rowvar=rowvar))


def mc_cor(x, method="inse", adjust=False, rowvar=False):
    return cor_from_cov(mc_cov(x, method=method, adjust=adjust, rowvar=rowvar))
