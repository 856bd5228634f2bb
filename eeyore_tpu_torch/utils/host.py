import numpy as np
import torch


def host_array(value):
    """A tensor (on any device) or an array-like as a numpy array; None
    stays None."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)
