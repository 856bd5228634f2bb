"""Blocked Metropolis-within-Gibbs over MLP node blocks.

Counterpart of ``eeyore_tpu/samplers/gibbs.py``: one systematic sweep per
draw over the model's parameter blocks (all incoming weights and the bias of
one node, ``models/mlp.py``), each optionally split into sub-blocks by
``chunk_evenly``. Sub-block b proposes ``scale_b * N(0, 1)`` on its own
coordinates only and is accepted by an MH test on the full log target,
log(u) < target(proposed) - target(current). ``accepted`` is a 0/1 vector
per sub-block, so block acceptance rates can be read.

As in the JAX package, and unlike the reference, rejected coordinates are
restored before the next sub-block's proposal (the reference leaks them into
later targets of the sweep, which breaks the sweep's detailed balance).

The blocking is plain Python, fixed per model: ``sub_blocks`` lists (flat
indices, scale, node block) in sweep order, which the whole-loop kernels
(``ops/resident_walk.py``, ``ops/resident_walk_dense.py``) compile in. Every
tensor carries the chains as its first dimension.
"""

import json
import numbers
from typing import NamedTuple

import torch

from eeyore_tpu_torch.samplers.base import TransitionKernel
from eeyore_tpu_torch.utils import chunk_evenly


class GibbsState(NamedTuple):
    sample: torch.Tensor      # [C, P]
    target_val: torch.Tensor  # [C]
    accepted: torch.Tensor    # [C, num_sub_blocks] int32


class Gibbs(TransitionKernel):
    state_keys = ("sample", "target_val", "accepted")

    def __init__(self, model, scales=1.0, node_subblock_size=None, recompute_current=False):
        super().__init__(model, recompute_current=recompute_current)
        if not hasattr(model, "num_par_blocks"):
            raise ValueError(
                "Gibbs needs a model exposing parameter blocks "
                "(num_par_blocks / par_block_indices, e.g. eeyore_tpu_torch.models.MLP); "
                f"{type(model).__name__} does not")
        num_blocks = model.num_par_blocks()
        if isinstance(scales, numbers.Real):
            scales = [scales] * num_blocks
        self.scales = [float(s) for s in scales]
        if node_subblock_size is None:
            node_subblock_size = [None] * num_blocks
        self.node_subblock_size = list(node_subblock_size)
        self.sub_blocks = [(tuple(int(i) for i in sub), self.scales[b], b)
                           for b, subs in enumerate(self.get_blocks()) for sub in subs]
        self.num_sub_blocks = len(self.sub_blocks)
        self._index = {}

    def get_blocks(self):
        """The blocking as a list of sub-block index lists per node block
        (reference gibbs.py:45-57)."""
        blocks = []
        for b in range(self.model.num_par_blocks()):
            indices = list(self.model.par_block_indices(b))
            size = self.node_subblock_size[b]
            blocks.append([indices] if size is None else list(chunk_evenly(indices, size)))
        return blocks

    def save_blocks(self, path="gibbs_blocks.txt", mode="w"):
        with open(path, mode) as f:
            json.dump(self.get_blocks(), f)

    def _indices(self, b, device):
        key = (b, str(device))
        if key not in self._index:
            self._index[key] = torch.tensor(self.sub_blocks[b][0], dtype=torch.int64,
                                            device=device)
        return self._index[key]

    def init(self, thetas, x, y, generator=None):
        thetas = torch.as_tensor(thetas)
        return GibbsState(sample=thetas, target_val=self.log_target(thetas, x, y),
                          accepted=torch.zeros((thetas.shape[0], self.num_sub_blocks),
                                               dtype=torch.int32, device=thetas.device))

    def step_fn(self, state, x, y, generator=None, noise=None, uniforms=None):
        """One sweep of every chain. ``noise``: a list of one [C, len(sub-block)]
        tensor of standard normals per sub-block, and ``uniforms`` [C,
        num_sub_blocks]; both drawn from ``generator`` unless given."""
        sample = state.sample
        target = (self.log_target(sample, x, y) if self.recompute_current
                  else state.target_val)
        C = sample.shape[0]
        like = dict(dtype=sample.dtype, device=sample.device)
        accepted = []
        for b, (indices, scale, _) in enumerate(self.sub_blocks):
            idx = self._indices(b, sample.device)
            z = (torch.randn((C, len(indices)), generator=generator, **like) if noise is None
                 else noise[b])
            proposed = sample.clone()
            proposed[:, idx] = sample[:, idx] + scale * z
            proposed_target = self.log_target(proposed, x, y)
            u = (torch.rand(C, generator=generator, **like) if uniforms is None
                 else uniforms[:, b])
            accept = torch.log(u) < proposed_target - target
            sample = torch.where(accept[:, None], proposed, sample)
            target = torch.where(accept, proposed_target, target)
            accepted.append(accept.to(torch.int32))
        new_state = GibbsState(sample=sample, target_val=target,
                               accepted=torch.stack(accepted, dim=1))
        return new_state, new_state._asdict()

    def step(self, state, x, y, iteration=None, generator=None):
        return self.step_fn(state, x, y, generator=generator)
