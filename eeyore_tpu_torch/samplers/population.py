"""Population kernels: samplers whose state is a whole ensemble of chains.

Counterpart of ``eeyore_tpu/samplers/population.py``: ``init`` takes the
ensemble's thetas and ``step`` advances all of it at once. The runner
``sample_population`` steps it in a Python loop over iterations, as
``runner._run_generic`` steps a transition kernel, with a
``torch.Generator`` in place of the JAX key; there is no compiled program to
cache. The recorded leaves come back chain-major, [C, kept, ...].
"""

import torch

from eeyore_tpu_torch.chains import ChainLists
from eeyore_tpu_torch.samplers.runner import _generator_or_default, _prepare


class PopulationKernel:
    """Like ``TransitionKernel``, but ``init`` takes the whole population's
    thetas and ``step`` advances the population."""

    state_keys = ("sample", "target_val", "accepted")

    def __init__(self, model, recompute_current=False):
        self.model = model
        self.recompute_current = recompute_current

    def init(self, thetas, x, y, generator=None):
        raise NotImplementedError

    def step(self, state, x, y, iteration, generator=None):
        raise NotImplementedError


def sample_population(kernel, generator, theta0s, data, num_iters, num_burnin_iters=0,
                      record_keys=None, return_state=False, return_arrays=False):
    """Run a population kernel; returns a ``ChainLists`` with one chain per
    member, [num_walkers, kept_iters, ...] (the stacked tensors with
    ``return_arrays=True``), and the final state with ``return_state=True``.
    ``theta0s`` sets the device; ``data`` is moved there."""
    theta0s, schedule = _prepare(kernel, theta0s, data, num_iters, num_burnin_iters, 1)
    kernel.recompute_current = schedule.num_batches != 1
    record_keys = tuple(record_keys or kernel.state_keys)
    generator = _generator_or_default(generator, theta0s.device)
    xb, yb = schedule.batch(0)
    state = kernel.init(theta0s, xb, yb, generator=generator)
    rows = {k: [] for k in record_keys}
    for i in range(num_iters):
        xb, yb = schedule.batch(i)
        state, info = kernel.step(state, xb, yb, i, generator=generator)
        if i >= num_burnin_iters:
            for k in record_keys:
                rows[k].append(info[k])
    recorded = {k: torch.stack(v, dim=1) if v else None for k, v in rows.items()}
    if return_arrays:
        return (recorded, state) if return_state else recorded
    chains = ChainLists.from_arrays(recorded)
    return (chains, state) if return_state else chains
