"""Bayesian MLP over a flat parameter vector.

Counterpart of ``eeyore_tpu/models/mlp.py``. Flat theta layout: for each
layer l, ``W_l`` of shape (dims[l+1], dims[l]) flattened row-major, then
``b_l`` of shape (dims[l+1],) when bias[l].
"""

import contextlib
import itertools

import torch

from eeyore_tpu_torch.models.model import BayesianModel
from eeyore_tpu_torch.models.priors import IIDNormalPrior


def sigmoid(x):
    return torch.sigmoid(x)


@contextlib.contextmanager
def float32_matmul_precision(precision):
    """Run the enclosed matmuls at ``precision`` ("highest" is full f32,
    never TF32) and restore the caller's setting afterwards."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


class Hyperparameters:
    """MLP architecture: ``dims`` including input and output sizes, per-layer
    ``bias`` flags and ``activations`` (None = linear output)."""

    def __init__(self, dims=(1, 2, 1), bias=None, activations="default"):
        self.dims = list(dims)
        num_layers = len(self.dims) - 1
        self.bias = list(bias) if bias is not None else [True] * num_layers
        if activations == "default":
            self.activations = [sigmoid] * num_layers
        else:
            self.activations = list(activations)

        if len(self.dims) < 3:
            raise ValueError("MLP needs at least one hidden layer (len(dims) >= 3)")
        if len(self.dims) != len(self.activations) + 1:
            raise ValueError("len(dims) must equal len(activations) + 1")
        if len(self.bias) != num_layers:
            raise ValueError("len(bias) must equal len(dims) - 1")


class MLP(BayesianModel):
    """Sigmoid MLP; ``forward`` takes ``theta [..., P]`` and ``x [n, dims[0]]``.

    The matmuls run at ``matmul_precision`` (default "highest": full f32).
    On the card a float32 matmul may otherwise run in TF32, which keeps about
    three decimal digits; on the TPU the same kind of rounding dropped iris
    HMC acceptance from 0.97 to 0.89. The model sets the precision itself
    around each forward pass rather than relying on the process default.
    """

    def __init__(self, loss, hparams=None, prior=None, temperature=None, dtype=None,
                 device="cuda", matmul_precision="highest"):
        super().__init__(loss, prior=prior, temperature=temperature, dtype=dtype, device=device)
        self.matmul_precision = matmul_precision
        self.hp = hparams or Hyperparameters()
        self._layer_shapes = self._compute_layer_shapes()
        self.num_params = sum(w_size + b_size for (_, w_size, b_size) in self._layer_shapes)
        self.prior = prior or self.default_prior()

    def default_prior(self):
        return IIDNormalPrior.standard(self.num_params, dtype=self.dtype, device=self.device)

    def _compute_layer_shapes(self):
        shapes = []
        for l in range(len(self.hp.dims) - 1):
            d_in, d_out = self.hp.dims[l], self.hp.dims[l + 1]
            shapes.append(((d_out, d_in), d_in * d_out, d_out if self.hp.bias[l] else 0))
        return shapes

    def unpack(self, theta):
        """Split flat theta [..., P] into [(W_l [..., out, in], b_l [..., out] or None)]."""
        layers = []
        i = 0
        for (w_shape, w_size, b_size) in self._layer_shapes:
            w = theta[..., i:i + w_size].reshape(theta.shape[:-1] + w_shape)
            i += w_size
            b = theta[..., i:i + b_size] if b_size else None
            i += b_size
            layers.append((w, b))
        return layers

    def pack(self, layers):
        """Inverse of unpack: flatten [(W, b)] back into theta."""
        parts = []
        for (w, b) in layers:
            parts.append(w.reshape(w.shape[:-2] + (-1,)))
            if b is not None:
                parts.append(b)
        return torch.cat(parts, dim=-1)

    def forward(self, theta, x):
        """x [n, dims[0]] -> [..., n, dims[-1]] for theta [..., P]."""
        h = x
        with float32_matmul_precision(self.matmul_precision):
            for (w, b), activation in zip(self.unpack(theta), self.hp.activations):
                h = torch.matmul(h, w.transpose(-1, -2))
                if b is not None:
                    h = h + b[..., None, :]
                if activation is not None:
                    h = activation(h)
        return h

    # Gibbs node-blocking geometry (eeyore_tpu/models/mlp.py:109-151): a
    # parameter block is all incoming weights and the bias of one hidden or
    # output node.

    def num_hidden_layers(self):
        return len(self.hp.dims) - 2

    def num_par_blocks(self):
        return sum(self.hp.dims[1:])

    def layer_and_node_from_par_block(self, b):
        """Block id -> (layer index, node index within the layer)."""
        cumulative = [0] + list(itertools.accumulate(self.hp.dims[1:]))
        for l in range(len(cumulative) - 1):
            if cumulative[l] <= b < cumulative[l + 1]:
                return l, b - cumulative[l]
        raise IndexError(f"block {b} out of range")

    def starting_par_block_idx(self, l):
        """Flat index where layer l's weights start."""
        s = 0
        for i in range(l):
            s += (self.hp.dims[i] + 1 if self.hp.bias[i] else self.hp.dims[i]) * self.hp.dims[i + 1]
        return s

    def starting_par_block_indices(self):
        return [self.starting_par_block_idx(l) for l in range(len(self.hp.dims) - 1)]

    def annotated_par_block_indices(self, b):
        """Flat theta indices of block b: node n's weight row and, with a
        bias, its bias entry (which sits after all of the layer's weights);
        with the layer and the node."""
        l, n = self.layer_and_node_from_par_block(b)
        s = self.starting_par_block_idx(l)
        indices = list(range(s + n * self.hp.dims[l], s + (n + 1) * self.hp.dims[l]))
        if self.hp.bias[l]:
            indices.append(s + self.hp.dims[l] * self.hp.dims[l + 1] + n)
        return indices, l, n

    def par_block_indices(self, b):
        return self.annotated_par_block_indices(b)[0]
