"""Minimum-likelihood-distance (MLD) batch selection.

Counterpart of ``eeyore_tpu/datasets/mld_batcher.py`` (reference
mld_classification_batcher.py:11-90): among ``num_batches`` candidate
class-stratified batches, pick the one whose mean log-likelihood under two
parameter vectors is closest to the full data's.

The candidates' indices are drawn on the host from ``np.random.
default_rng(seed)`` in the JAX package's order, so both packages pick the
same batch for the same seed. The log-likelihoods of every candidate under
both parameter vectors come from one batched call of the model, and the
full data's from one more.
"""

import numpy as np
import torch

from eeyore_tpu_torch.utils.host import host_array


class MLDBatcher:
    pass


class MLDClassificationBatcher(MLDBatcher):
    def __init__(self, num_batches, chunk_sizes, dataset=None, seed=0):
        self.num_batches = num_batches
        self.chunk_sizes = list(chunk_sizes)
        assert len(self.chunk_sizes) == 2
        self.rng = np.random.default_rng(seed)
        self.set_dataset(dataset)

    def set_dataset(self, dataset):
        self.dataset = dataset
        if dataset is None:
            return
        y = host_array(dataset.y)
        self.num_points = len(dataset)
        self.num_classes = y.shape[1]
        labels = np.argmax(y, axis=1)
        self.class_indices = [np.where(labels == c)[0] for c in range(self.num_classes)]
        self.class_props = [len(ci) / self.num_points for ci in self.class_indices]
        # stratified counts of each chunk (floor), the remainder filled at random
        self.class_num_batch_points = [
            [int(self.class_props[c] * self.chunk_sizes[k]) for c in range(self.num_classes)]
            for k in range(2)
        ]

    def batch_size(self):
        return sum(self.chunk_sizes)

    def _fill_class_sizes(self):
        counts = [list(c) for c in self.class_num_batch_points]
        for k in range(2):
            deficit = self.chunk_sizes[k] - sum(counts[k])
            for c in self.rng.choice(self.num_classes, size=deficit):
                counts[k][c] += 1
        return counts

    def _candidate_indices(self):
        counts = self._fill_class_sizes()
        first, second = [], []
        for c in range(self.num_classes):
            chosen = self.rng.choice(self.class_indices[c], size=counts[0][c], replace=False)
            first.extend(chosen.tolist())
            rest = np.setdiff1d(self.class_indices[c], chosen)
            second.extend(self.rng.choice(rest, size=counts[1][c], replace=False).tolist())
        return sorted(first + second)

    def get_batch(self, model, params):
        """(x, y) of the candidate batch whose mean log-likelihood under both
        parameter vectors is closest to the full data's, as host arrays (the
        first such candidate on a tie)."""
        device = getattr(model, "device", None)
        dtype = getattr(model, "dtype", None)
        x_host, y_host = host_array(self.dataset.x), host_array(self.dataset.y)
        candidates = np.asarray([self._candidate_indices() for _ in range(self.num_batches)])
        x = torch.as_tensor(x_host).to(device=device, dtype=dtype)
        y = torch.as_tensor(y_host).to(device=device, dtype=dtype)
        thetas = torch.stack([torch.as_tensor(host_array(t)) for t in params]).to(device=device,
                                                                             dtype=dtype)
        idx = torch.as_tensor(candidates, device=x.device)
        full = model.log_lik(thetas, x, y) / self.num_points                      # [T]
        sub = model.log_lik(thetas[:, None, :], x[idx], y[idx]) / candidates.shape[1]  # [T, B]
        dist = torch.sqrt(torch.sum(torch.abs(full[:, None] - sub), dim=0)).cpu().numpy()
        best = int(np.argmin(np.where(np.isnan(dist), np.inf, dist)))
        return x_host[candidates[best]], y_host[candidates[best]]
