"""Plain log-posterior of a Bayesian MLP, batched over parameter vectors.

The model as its configuration file states it: for each layer l, the weight
W_l of shape (dims[l+1], dims[l]) flattened row-major and then the bias b_l;
sigmoid hidden units; a linear output under the multiclass cross-entropy
(one-hot labels) or a sigmoid output under the binary cross-entropy; an iid
Normal prior. Written with plain torch operations and autograd, in whatever
dtype it is given, so the same code is the float64 reference and the
bfloat16 control.
"""

import math

import torch


class MLPPosterior:
    """``vg(theta [B, P]) -> (log posterior [B], gradient [B, P])`` on the
    data ``x [N, d0]``, ``y [N, k]``, all in ``dtype`` on ``device``."""

    def __init__(self, config, x, y, dtype, device):
        self.dims = list(config["dims"])
        self.loss = config["loss"]
        if self.loss not in ("multiclass_classification", "binary_classification"):
            raise ValueError(f"unknown loss {self.loss!r}")
        if config["hidden_activation"] != "sigmoid":
            raise ValueError("the reference MLP has sigmoid hidden units")
        prior = config["prior"]
        self.loc, self.scale = float(prior["loc"]), float(prior["scale"])
        self.num_params = sum(self.dims[l] * self.dims[l + 1] + self.dims[l + 1]
                              for l in range(len(self.dims) - 1))
        if self.num_params != config["num_params"]:
            raise ValueError("the configuration's num_params disagrees with its dims")
        self.dtype = dtype
        self.x = torch.as_tensor(x).to(device=device, dtype=dtype)
        self.y = torch.as_tensor(y).to(device=device, dtype=dtype)
        self.prior_const = self.num_params * (-math.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def log_posterior(self, theta):
        B = theta.shape[0]
        h = self.x.expand(B, -1, -1)
        off = 0
        L = len(self.dims) - 1
        for l in range(L):
            d_in, d_out = self.dims[l], self.dims[l + 1]
            w = theta[:, off:off + d_in * d_out].reshape(B, d_out, d_in)
            off += d_in * d_out
            b = theta[:, off:off + d_out]
            off += d_out
            z = torch.matmul(h, w.transpose(1, 2)) + b[:, None, :]
            h = torch.sigmoid(z) if l < L - 1 else z
        if self.loss == "multiclass_classification":
            log_lik = torch.sum(self.y * torch.log_softmax(h, dim=-1), dim=(1, 2))
        else:
            log_lik = torch.sum(self.y * h - torch.nn.functional.softplus(h), dim=(1, 2))
        diff = (theta - self.loc) / self.scale
        return log_lik - 0.5 * torch.sum(diff * diff, dim=1) + self.prior_const

    def vg(self, theta):
        """The value and its gradient, by the chain rule written out
        (``log_posterior`` is the same value through autograd's eyes)."""
        theta = theta.to(self.dtype)
        B = theta.shape[0]
        L = len(self.dims) - 1
        weights, acts, off = [], [self.x], 0
        h = self.x
        for l in range(L):
            d_in, d_out = self.dims[l], self.dims[l + 1]
            w = theta[:, off:off + d_in * d_out].reshape(B, d_out, d_in)
            off += d_in * d_out
            b = theta[:, off:off + d_out]
            off += d_out
            weights.append(w)
            z = torch.matmul(h, w.transpose(1, 2)) + b[:, None, :]
            if l < L - 1:
                h = torch.sigmoid(z)
                acts.append(h)
        if self.loss == "multiclass_classification":
            logp = torch.log_softmax(z, dim=-1)
            log_lik = torch.sum(self.y * logp, dim=(1, 2))
            delta = self.y - torch.exp(logp)
        else:
            log_lik = torch.sum(self.y * z - torch.nn.functional.softplus(z), dim=(1, 2))
            delta = self.y - torch.sigmoid(z)
        diff = (theta - self.loc) / self.scale
        val = log_lik - 0.5 * torch.sum(diff * diff, dim=1) + self.prior_const
        parts = []
        for l in reversed(range(L)):
            a = acts[l]
            g_w = torch.matmul(delta.transpose(1, 2), a)
            parts.append(torch.sum(delta, dim=1))
            parts.append(g_w.reshape(B, g_w.shape[1] * g_w.shape[2]))
            if l > 0:
                delta = torch.matmul(delta, weights[l]) * a * (1.0 - a)
        grad = torch.cat(parts[::-1], dim=1) - diff / self.scale
        return val, grad
