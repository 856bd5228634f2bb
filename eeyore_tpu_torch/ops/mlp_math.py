"""Chain-batched MLP log-posterior with a hand-derived gradient.

Counterpart of ``eeyore_tpu/ops/mlp_math.py`` (``extract_arch``,
``prepare_data``, ``make_vg``). ``make_vg`` builds the plain PyTorch version
of the fused kernel in ``ops/csrc/fused_mlp_vg.cu``:
``vg(theta [P, C], x, y, mask, loc, ivar) -> (val [1, C], grad [P, C])``,
written per unit as elementwise ops over ``[n_pad, C]`` (data rows by
chains), in the dtype of ``theta``.
"""

import math

import numpy as np
import torch

from eeyore_tpu_torch.models import mlp
from eeyore_tpu_torch.models.losses import (
    binary_classification_loss,
    multiclass_classification_loss,
)
from eeyore_tpu_torch.models.priors import IIDNormalPrior
from eeyore_tpu_torch.utils.host import host_array


def _is_sigmoid(activation):
    return activation is mlp.sigmoid or activation is torch.sigmoid


def extract_arch(model):
    """Static architecture of an MLP or a LogisticRegression (a one-layer
    MLP: ``dims = [input_size, output_size]``): (dims, bias, loss_kind,
    layer_offsets), with ``layer_offsets[l] = (w_off, b_off or None)`` into
    the flat theta. Raises ValueError for anything the kernels do not
    compute: they hard-code sigmoid hidden units (and a sigmoid BCE output)
    and an IID Normal prior."""
    hp = model.hp
    dims = list(hp.dims) if hasattr(hp, "dims") else [hp.input_size, hp.output_size]
    bias = list(hp.bias) if isinstance(hp.bias, (list, tuple)) else [hp.bias]
    activations = hp.activations if hasattr(hp, "activations") else [hp.activation]

    if model.loss is binary_classification_loss:
        loss_kind = "bce"
        if not _is_sigmoid(activations[-1]):
            raise ValueError("BCE path expects a sigmoid output layer")
    elif model.loss is multiclass_classification_loss:
        loss_kind = "ce"
        if activations[-1] is not None:
            raise ValueError("CE path expects a linear (logits) output layer")
    else:
        raise ValueError("fused kernels support the registered BCE/CE losses only")
    for act in activations[:-1]:
        if not _is_sigmoid(act):
            raise ValueError("hidden activations must be sigmoid (models.mlp.sigmoid or "
                             f"torch.sigmoid), got {act!r}")
    if not isinstance(model.prior, IIDNormalPrior):
        raise ValueError(f"the kernels take an IIDNormalPrior, got {type(model.prior).__name__}")

    layer_offsets = []
    off = 0
    for l in range(len(dims) - 1):
        w_off = off
        off += dims[l] * dims[l + 1]
        b_off = off if bias[l] else None
        if bias[l]:
            off += dims[l + 1]
        layer_offsets.append((w_off, b_off))
    if off != model.num_params:
        raise ValueError(f"layout covers {off} parameters, model has {model.num_params}")
    return dims, bias, loss_kind, layer_offsets


def prepare_data(model, x, y, dtype=np.float32):
    """Pad the rows to a multiple of 8 (with a row mask) and pack the prior
    constants, as numpy arrays of ``dtype``:
    (x_pad, y_pad, row_mask, prior_loc [P,1], prior_inv_var [P,1],
    prior_const, temperature). Raises where ``extract_arch`` does."""
    extract_arch(model)
    x = np.asarray(x)
    y = np.asarray(y)
    n = x.shape[0]
    n_pad = ((max(n, 8) + 7) // 8) * 8

    x_pad = np.zeros((n_pad, x.shape[1]), dtype=dtype)
    x_pad[:n] = x
    y_pad = np.zeros((n_pad, y.shape[1]), dtype=dtype)
    y_pad[:n] = y
    row_mask = np.zeros((n_pad, 1), dtype=dtype)
    row_mask[:n] = 1.0

    P = model.num_params
    loc = host_array(model.prior.loc)
    scale = host_array(model.prior.scale)
    prior_loc = loc.astype(dtype).reshape(P, 1)
    prior_inv_var = (1.0 / scale.astype(dtype) ** 2).reshape(P, 1)
    prior_const = float(np.sum(-np.log(scale.astype(np.float64)) - 0.5 * math.log(2.0 * math.pi)))
    temperature = 1.0 if model.temperature is None else float(model.temperature)
    return x_pad, y_pad, row_mask, prior_loc, prior_inv_var, prior_const, temperature


def make_vg(model, x_pad, y_pad, row_mask, prior_loc, prior_inv_var, prior_const,
            temperature, with_grad=True, split=False):
    """Build vg(theta [P, C], x, y, mask, loc, ivar) -> (val [1, C], grad [P, C]).

    The data and prior arrays are passed per call, as the kernel receives
    them. With ``with_grad=False`` only ``val [1, C]`` is returned. With
    ``split=True`` the log-likelihood and log-prior come back separately and
    untempered: ``(ll, lp, gll, glp)``, or ``(ll, lp)`` without gradient.
    """
    dims, bias, loss_kind, layer_offsets = extract_arch(model)
    num_layers = len(dims) - 1
    P = model.num_params

    def vg(theta, x, y, mask, loc, ivar):
        n_pad, C = x.shape[0], theta.shape[1]

        def zeros(rows):
            return torch.zeros((rows, C), dtype=theta.dtype, device=theta.device)

        def w_row(l, j, i):
            w_off, _ = layer_offsets[l]
            return theta[w_off + j * dims[l] + i, :][None, :]

        def b_row(l, j):
            _, b_off = layer_offsets[l]
            return theta[b_off + j, :][None, :]

        acts = [[x[:, i][:, None] for i in range(dims[0])]]
        zs = []
        for l in range(num_layers):
            z_l = []
            for j in range(dims[l + 1]):
                z = zeros(n_pad)
                for i in range(dims[l]):
                    z = z + acts[l][i] * w_row(l, j, i)
                if bias[l]:
                    z = z + b_row(l, j)
                z_l.append(z)
            zs.append(z_l)
            if l < num_layers - 1 or loss_kind == "bce":
                acts.append([torch.sigmoid(z) for z in z_l])
            else:
                acts.append(z_l)

        k_out = dims[-1]
        if loss_kind == "bce":
            log_lik = zeros(1)
            deltas = []
            for j in range(k_out):
                z = zs[-1][j]
                yj = y[:, j][:, None]
                softplus = torch.clamp(z, min=0) + torch.log1p(torch.exp(-torch.abs(z)))
                log_lik = log_lik + torch.sum((yj * z - softplus) * mask, dim=0, keepdim=True)
                if with_grad:
                    deltas.append((yj - acts[-1][j]) * mask)
        else:
            zmax = zs[-1][0]
            for j in range(1, k_out):
                zmax = torch.maximum(zmax, zs[-1][j])
            # the k shifted exps serve both the log-sum-exp and the softmax
            exps = [torch.exp(zs[-1][j] - zmax) for j in range(k_out)]
            sumexp = zeros(n_pad)
            for e in exps:
                sumexp = sumexp + e
            lse = zmax + torch.log(sumexp)
            picked = zeros(n_pad)
            for j in range(k_out):
                picked = picked + y[:, j][:, None] * zs[-1][j]
            log_lik = torch.sum((picked - lse) * mask, dim=0, keepdim=True)
            if with_grad:
                inv_sumexp = 1.0 / sumexp
                deltas = [(y[:, j][:, None] - exps[j] * inv_sumexp) * mask
                          for j in range(k_out)]

        diff = theta - loc
        log_prior = torch.sum(-0.5 * diff * diff * ivar, dim=0, keepdim=True) + prior_const
        val = temperature * (log_lik + log_prior)
        if not with_grad:
            return (log_lik, log_prior) if split else val

        grad_rows = [None] * P
        for l in reversed(range(num_layers)):
            w_off, b_off = layer_offsets[l]
            for j in range(dims[l + 1]):
                for i in range(dims[l]):
                    grad_rows[w_off + j * dims[l] + i] = torch.sum(
                        deltas[j] * acts[l][i], dim=0, keepdim=True)
                if bias[l]:
                    grad_rows[b_off + j] = torch.sum(deltas[j], dim=0, keepdim=True)
            if l > 0:
                new_deltas = []
                for i in range(dims[l]):
                    s = zeros(n_pad)
                    for j in range(dims[l + 1]):
                        s = s + deltas[j] * w_row(l, j, i)
                    a = acts[l][i]
                    new_deltas.append(s * a * (1.0 - a))
                deltas = new_deltas

        grad = torch.cat(grad_rows, dim=0)  # [P, C] d(log_lik)/d(theta)
        if split:
            return log_lik, log_prior, grad, -diff * ivar
        grad = temperature * (grad - diff * ivar)
        return val, grad

    return vg


def make_incremental_gibbs(model, n_pad, temperature, prior_const):
    """Incremental value-only log-posterior for blocked Gibbs sweeps.

    Counterpart of ``eeyore_tpu/ops/mlp_math.py::make_incremental_gibbs``.
    A node-block proposal perturbs only the incoming weights and bias of one
    unit (layer l, node j), so only that unit's activation and everything
    downstream changes. Returns ``(cache_keys, init, updates)``:

    - ``cache_keys``: the cached arrays, hidden activations ``('a', l, j)``
      [n_pad, C] and, per loss, the output units' log-likelihoods ``('ll',
      j)`` [1, C] (BCE) or the output logits ``('z', j)`` [n_pad, C] (CE);
    - ``init(theta, x, y, mask, loc, ivar) -> (val [1, C], cache)``: the full
      forward pass;
    - ``updates[(l, j)](theta, x, y, mask, loc, ivar, cache) -> (val,
      new_cache)``: unit (l, j) from the cached upstream activations, then
      every layer strictly downstream; unchanged cache entries come back as
      the very same objects, so a caller selects only what moved.

    The value is bit-identical to ``make_vg(..., with_grad=False)`` after any
    sequence of updates: the cache holds the floats the full pass would
    recompute, and every sum runs in ``make_vg``'s order.
    """
    dims, bias, loss_kind, layer_offsets = extract_arch(model)
    num_layers = len(dims) - 1
    k_out = dims[-1]
    cache_keys = tuple(("a", l, j) for l in range(num_layers - 1) for j in range(dims[l + 1]))
    cache_keys += tuple(("ll" if loss_kind == "bce" else "z", j) for j in range(k_out))
    key_pos = {k: i for i, k in enumerate(cache_keys)}

    def unit_z(theta, prev, l, j):
        w_off, b_off = layer_offsets[l]
        z = torch.zeros((n_pad, theta.shape[1]), dtype=theta.dtype, device=theta.device)
        for i in range(dims[l]):
            z = z + prev[i] * theta[w_off + j * dims[l] + i, :][None, :]
        if bias[l]:
            z = z + theta[b_off + j, :][None, :]
        return z

    def layer_inputs(x, cache, l):
        if l == 0:
            return [x[:, i][:, None] for i in range(dims[0])]
        return [cache[key_pos[("a", l - 1, i)]] for i in range(dims[l])]

    def bce_unit_ll(z, y, mask, j):
        softplus = torch.clamp(z, min=0) + torch.log1p(torch.exp(-torch.abs(z)))
        return torch.sum((y[:, j][:, None] * z - softplus) * mask, dim=0, keepdim=True)

    def log_lik(cache, y, mask):
        C = cache[0].shape[1]
        like = dict(dtype=cache[0].dtype, device=cache[0].device)
        if loss_kind == "bce":
            ll = torch.zeros((1, C), **like)
            for j in range(k_out):
                ll = ll + cache[key_pos[("ll", j)]]
            return ll
        zs = [cache[key_pos[("z", j)]] for j in range(k_out)]
        zmax = zs[0]
        for j in range(1, k_out):
            zmax = torch.maximum(zmax, zs[j])
        sumexp = torch.zeros((n_pad, C), **like)
        for j in range(k_out):
            sumexp = sumexp + torch.exp(zs[j] - zmax)
        lse = zmax + torch.log(sumexp)
        picked = torch.zeros((n_pad, C), **like)
        for j in range(k_out):
            picked = picked + y[:, j][:, None] * zs[j]
        return torch.sum((picked - lse) * mask, dim=0, keepdim=True)

    def finish(theta, y, mask, loc, ivar, cache):
        diff = theta - loc
        log_prior = torch.sum(-0.5 * diff * diff * ivar, dim=0, keepdim=True) + prior_const
        return temperature * (log_lik(cache, y, mask) + log_prior)

    def forward(theta, x, y, mask, cache, first_layer, units):
        """Recompute ``units`` of ``first_layer`` (all units of the later
        layers) into a copy of ``cache``."""
        cache = list(cache)
        for l in range(first_layer, num_layers):
            prev = layer_inputs(x, cache, l)
            for j in (units if l == first_layer else range(dims[l + 1])):
                z = unit_z(theta, prev, l, j)
                if l < num_layers - 1:
                    cache[key_pos[("a", l, j)]] = torch.sigmoid(z)
                elif loss_kind == "bce":
                    cache[key_pos[("ll", j)]] = bce_unit_ll(z, y, mask, j)
                else:
                    cache[key_pos[("z", j)]] = z
        return tuple(cache)

    def init(theta, x, y, mask, loc, ivar):
        cache = forward(theta, x, y, mask, [None] * len(cache_keys), 0, range(dims[1]))
        return finish(theta, y, mask, loc, ivar, cache), cache

    def make_update(l, j):
        def update(theta, x, y, mask, loc, ivar, cache):
            cache = forward(theta, x, y, mask, cache, l, (j,))
            return finish(theta, y, mask, loc, ivar, cache), cache
        return update

    updates = {(l, j): make_update(l, j) for l in range(num_layers) for j in range(dims[l + 1])}
    return cache_keys, init, updates
