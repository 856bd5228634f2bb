"""Index draws with exclusion (DEMC partner selection).

Counterpart of ``eeyore_tpu/stats/random.py``: one uniform draw from the
n - len(exclude) allowed slots, shifted past the excluded indices (no
rejection loop). Draws come from an explicit ``torch.Generator`` and land on
its device.
"""

import torch


def choose(generator, n):
    """Uniform index in [0, n), a 0-d int64 tensor."""
    return torch.randint(0, n, (), generator=generator, device=generator.device)


def choose_from_subset(generator, n, exclude):
    """Uniform index in [0, n) that is none of ``exclude``."""
    exclude = sorted(exclude)
    idx = torch.randint(0, n - len(exclude), (), generator=generator, device=generator.device)
    for e in exclude:
        idx = torch.where(idx >= e, idx + 1, idx)
    return idx
