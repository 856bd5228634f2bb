"""Static batch schedules: minibatches stacked as [B, bs, ...] tensors.

Counterpart of ``eeyore_tpu/datasets/batches.py``. The sampler indexes batch
``i % num_batches`` at iteration ``i`` (the reference's epoch loop over a
DataLoader); full-batch runs use a single (x, y) pair.
"""

import numpy as np
import torch


class BatchSchedule:
    """Stacked minibatches: x [B, bs, dx], y [B, bs, dy]."""

    def __init__(self, x_batches, y_batches):
        self.x = torch.as_tensor(x_batches)
        self.y = torch.as_tensor(y_batches)
        self.num_batches = self.x.shape[0]

    @classmethod
    def full_batch(cls, x, y):
        return cls(torch.as_tensor(x)[None], torch.as_tensor(y)[None])

    @classmethod
    def from_dataset(cls, dataset, batch_size=None, generator=None, drop_last=True):
        """Build a one-epoch schedule. With a ``torch.Generator``, points
        are shuffled once; uneven tails are dropped."""
        x = torch.as_tensor(np.asarray(dataset.x))
        y = torch.as_tensor(np.asarray(dataset.y))
        n = len(x)
        batch_size = batch_size or n
        if batch_size >= n:
            return cls(x[None], y[None])
        if generator is not None:
            perm = torch.randperm(n, generator=generator)
            x, y = x[perm], y[perm]
        num_batches = n // batch_size
        if not drop_last and n % batch_size != 0:
            raise ValueError(
                "uneven last batch is not representable with static shapes; "
                "use drop_last=True or a batch_size dividing the dataset size"
            )
        end = num_batches * batch_size
        return cls(
            x[:end].reshape(num_batches, batch_size, *x.shape[1:]),
            y[:end].reshape(num_batches, batch_size, *y.shape[1:]),
        )

    def batch(self, i):
        """Batch for iteration i (cyclic)."""
        idx = i % self.num_batches
        return self.x[idx], self.y[idx]

    def to(self, device=None, dtype=None):
        """The same schedule with its tensors on ``device`` in ``dtype``
        (this one when nothing changes)."""
        x = self.x.to(device=device, dtype=dtype)
        y = self.y.to(device=device, dtype=dtype)
        if x is self.x and y is self.y:
            return self
        return BatchSchedule(x, y)


def as_schedule(data):
    """Normalize user data into a BatchSchedule: accepts a BatchSchedule, an
    (x, y) tuple (full batch), or a dataset object with .x/.y."""
    if isinstance(data, BatchSchedule):
        return data
    if isinstance(data, tuple) and len(data) == 2:
        x, y = data
    elif hasattr(data, "x") and hasattr(data, "y"):
        x, y = data.x, data.y
    else:
        raise TypeError(f"cannot interpret {type(data)!r} as batch data")
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if not isinstance(y, torch.Tensor):
        y = np.asarray(y)
    return BatchSchedule.full_batch(x, y)
