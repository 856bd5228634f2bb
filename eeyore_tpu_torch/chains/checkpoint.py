"""Checkpoint and resume of a whole sampler state.

Counterpart of ``eeyore_tpu/chains/checkpoint.py``: the leaves of a state
(the port's state ``NamedTuple``s, nested, with ``None`` fields skipped)
go into one ``.npz`` file as ``leaf_0``, ``leaf_1``, ... in depth-first
field order, the order of ``jax.tree_util.tree_leaves`` on the JAX
package's states, whose fields match the port's. So a checkpoint written
by either package loads into the other. Loading takes an example state of
the same structure (``like``) and puts each leaf on its device and dtype.
"""

import numpy as np
import torch


def _is_node(x):
    return isinstance(x, tuple)


def _leaves(state):
    if state is None:
        return []
    if _is_node(state):
        return [leaf for field in state for leaf in _leaves(field)]
    return [state]


def _rebuild(like, leaves):
    if like is None:
        return None
    if _is_node(like):
        fields = [_rebuild(field, leaves) for field in like]
        return type(like)(*fields) if hasattr(like, "_fields") else type(like)(fields)
    return next(leaves)


def save_state(path, state):
    """Save a state's leaves (tensors) to ``path`` (.npz), on the host."""
    np.savez(path, **{f"leaf_{i}": leaf.detach().cpu().numpy()
                      for i, leaf in enumerate(_leaves(state))})


def load_state(path, like):
    """Load a state saved by ``save_state`` (either package's); ``like``
    gives the structure, and each leaf's device, dtype and shape."""
    path = str(path)
    if not path.endswith(".npz"):
        path = path + ".npz"
    like_leaves = _leaves(like)
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    if len(leaves) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, example state has {len(like_leaves)}")
    return _rebuild(like, iter([torch.as_tensor(a, device=ref.device).to(ref.dtype).reshape(
        ref.shape) for a, ref in zip(leaves, like_leaves)]))
