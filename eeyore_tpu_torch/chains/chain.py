"""Chain storage protocol.

Counterpart of ``eeyore_tpu/chains/chain.py``: a chain backend needs
``reset`` and ``update(state)``; ``detach_and_update`` records detached
copies, so stored samples never hold an autograd graph.
"""

import torch


def _detached(value):
    return value.detach().clone() if isinstance(value, torch.Tensor) else value


class Chain:
    def reset(self):
        raise NotImplementedError

    def update(self, state):
        raise NotImplementedError

    def detach_and_update(self, state):
        self.update({key: _detached(val) for key, val in state.items()})
