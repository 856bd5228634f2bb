"""Posterior-predictive Monte-Carlo integration with NaN-dropping.

Counterpart of ``eeyore_tpu/integrators/mc.py``: the integral is the mean of
``f(sample, x, y)`` over posterior samples, NaN integrands dropped and
counted. ``f`` takes the samples as one batch ``[S, P]`` (the port's models
take ``theta [..., P]``), so an integral is one batched evaluation and a
masked mean, on the samples' device.
"""

import numpy as np
import torch


class Integrator:
    pass


class MCIntegrator(Integrator):
    def __init__(self, f=None, samples=None):
        self.f = f
        self.samples = samples

    def integrate(self, x, y):
        """(integral, num_dropped_samples); NaN integrands are left out of
        the mean, which is 0 when every integrand is NaN. ``x`` and ``y``
        (when not None) go to the samples' device and dtype."""
        samples = torch.as_tensor(self.samples)
        x, y = (None if a is None else torch.as_tensor(a, dtype=samples.dtype,
                                                         device=samples.device) for a in (x, y))
        vals = self.f(samples, x, y)
        nan_mask = torch.isnan(vals)
        num_dropped = int(nan_mask.sum())
        num_kept = vals.shape[0] - num_dropped
        kept = torch.where(nan_mask, torch.zeros_like(vals), vals)
        integral = kept.sum() / max(num_kept, 1)  # 0 when every integrand is NaN
        return integral, num_dropped

    def integrate_from_dataset(self, dataset, num_points, generator=None, shuffle=True):
        """Integrate over ``num_points`` single-point batches of the dataset,
        cycling through it when ``num_points`` exceeds its length (numpy's
        ``resize``). Returns (integrals, indices, nums_dropped) as numpy
        arrays. The order is shuffled by ``torch.randperm`` on ``generator``
        (a fresh generator seeded 0 when None); JAX shuffles with its own
        permutation, so only ``shuffle=False`` gives JAX's indices."""
        n = len(dataset)
        if shuffle:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            order = torch.randperm(n, generator=generator, device=generator.device).cpu().numpy()
        else:
            order = np.arange(n)
        idx = np.resize(order, num_points)

        integrals = np.empty(num_points)
        nums_dropped = np.empty(num_points, dtype=np.int64)
        for i, j in enumerate(idx):
            integral, dropped = self.integrate(dataset.x[j:j + 1], dataset.y[j:j + 1])
            integrals[i] = float(integral)
            nums_dropped[i] = dropped
        return integrals, idx, nums_dropped
