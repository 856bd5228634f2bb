"""Iteration and epoch bookkeeping shared by samplers, tuners and burn-in.

Counterpart of ``eeyore_tpu/datasets/counter.py``, in plain Python: the
number of iterations is the number of epochs times the number of batches,
and ceiling division goes the other way; a partial last batch counts unless
it is dropped. The counter holds the totals and one global ``idx``.
"""

import math


def _iters_for(num_epochs, num_batches):
    return None if num_epochs is None else num_epochs * num_batches


def _epochs_for(num_iters, num_batches):
    return None if num_iters is None else math.ceil(num_iters / num_batches)


class DataCounter:
    def __init__(self, batch_size, sample_size, num_epochs=None, num_burnin_epochs=None,
                 num_batches=None, drop_last=False):
        self.set_data_info(batch_size, sample_size, num_batches=num_batches,
                           drop_last=drop_last)
        self.set_epoch_info(num_epochs, num_burnin_epochs)
        self.idx = 0

    def set_data_info(self, batch_size, sample_size, num_batches=None, drop_last=False):
        self.batch_size = batch_size
        self.sample_size = sample_size
        if num_batches is not None:
            self.num_batches = num_batches
        else:
            whole, leftover = divmod(sample_size, batch_size)
            self.num_batches = whole + (1 if leftover and not drop_last else 0)

    def set_epoch_info(self, num_epochs, num_burnin_epochs):
        self.num_epochs = num_epochs
        self.num_burnin_epochs = num_burnin_epochs
        self.num_iters = _iters_for(num_epochs, self.num_batches)
        self.num_burnin_iters = _iters_for(num_burnin_epochs, self.num_batches)

    def set_iter_info(self, num_iters, num_burnin_iters):
        self.num_iters = num_iters
        self.num_burnin_iters = num_burnin_iters
        self.num_epochs = _epochs_for(num_iters, self.num_batches)
        self.num_burnin_epochs = _epochs_for(num_burnin_iters, self.num_batches)

    @classmethod
    def from_dataset(cls, dataset, batch_size=None, num_epochs=None, num_burnin_epochs=None):
        return cls(batch_size or len(dataset), len(dataset),
                   num_epochs=num_epochs, num_burnin_epochs=num_burnin_epochs)

    def reset(self):
        self.idx = 0

    def increment_idx(self, incr=1):
        self.idx += incr
