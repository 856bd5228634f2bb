"""Dual-averaging step-size adaptation (Hoffman & Gelman 2014, Algs 4-5).

Counterpart of ``eeyore_tpu/tuners/dual_averaging.py``: targets acceptance
d=0.65 with g=0.05, t0=10, k=0.75, m = log(10 e0), and an optional step upper
bound ``eub``. The state is a tuple of 0-d tensors on the sampler's device,
so a tuning step needs no host round trip.
"""

import math
from typing import NamedTuple

import torch


class DualAveragingState(NamedTuple):
    m: torch.Tensor        # log(10 * e0)
    barh: torch.Tensor     # running (d - rate) average
    logbare: torch.Tensor  # averaged log step
    loge: torch.Tensor     # last instantaneous log step


class HMCDATuner:
    """Static tuner config; ``init`` and ``tune`` are pure."""

    def __init__(self, l=None, e0=None, d=0.65, eub=None, g=0.05, t0=10, k=0.75):
        self.l = l          # target trajectory length: num_steps = max(1, round(l / e));
                            # None means num_steps() pins 1
        self.e0 = e0        # initial step
        self.d = d          # target acceptance rate
        self.eub = eub      # optional upper bound on the step during tuning
        self.g = g
        self.t0 = t0
        self.k = k

    def init(self, e0, dtype=None, device="cuda"):
        e0 = torch.as_tensor(e0, dtype=dtype, device=device)
        return DualAveragingState(
            m=torch.log(10.0 * e0),
            barh=torch.zeros_like(e0),
            logbare=torch.zeros_like(e0),
            loge=torch.log(e0),
        )

    def num_steps(self, e):
        """max(1, round(l / e)) as int32 (round half to even, as in JAX);
        1 when no trajectory length was configured."""
        if self.l is None:
            return torch.ones_like(e, dtype=torch.int32)
        return torch.clamp(torch.round(self.l / e), min=1).to(torch.int32)

    def tune(self, state, rate, idx, return_e):
        """One dual-averaging update at global iteration ``idx`` (0-based).

        ``return_e``: True -> the instantaneous step (burn-in), False -> the
        averaged step (from the last burn-in iteration on). ``idx`` is a host
        integer, so the weights are host floats and need no copy to the device.
        """
        it = float(idx + 1)
        d_w = 1.0 / (it + self.t0)
        e_w = it ** (-self.k)

        barh = (1.0 - d_w) * state.barh + d_w * (self.d - rate)
        loge = state.m - math.sqrt(it) * barh / self.g
        if self.eub is not None:
            loge = torch.clamp(loge, max=math.log(self.eub))
        logbare = e_w * loge + (1.0 - e_w) * state.logbare

        new_state = DualAveragingState(m=state.m, barh=barh, logbare=logbare, loge=loge)
        e = torch.exp(loge) if return_e else torch.exp(logbare)
        return new_state, e, self.num_steps(e)
