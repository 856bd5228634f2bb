"""Reads from a tensor to the host, counted where they wait for a card.

A read of a CUDA tensor (``.cpu()``, ``int()``, ``float()``, ``.item()``)
waits for the card's queued work and copies back: a host sync. Code on the
hot path reads through ``host_array`` and ``host_scalar``, which count the
reads of CUDA tensors in ``sync_counts["syncs"]`` (always on, as the ops
modules' ``launch_counts``); reads of CPU tensors and of anything else are
not counted.
"""

import numpy as np
import torch

sync_counts = {"syncs": 0}


def _count(value):
    if value.is_cuda:
        sync_counts["syncs"] += 1


def host_array(value):
    """A tensor (on any device) or an array-like as a numpy array; None
    stays None."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        _count(value)
        return value.detach().cpu().numpy()
    return np.asarray(value)


def host_scalar(value):
    """A one-element tensor (on any device) as a Python number; anything
    else is returned as it is."""
    if isinstance(value, torch.Tensor):
        _count(value)
        return value.item()
    return value
