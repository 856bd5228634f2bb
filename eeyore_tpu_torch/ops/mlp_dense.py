"""MLP log-posterior with the data folded in as constants, for small data.

Counterpart of ``eeyore_tpu/ops/mlp_dense.py`` (``MAX_DENSE_ROWS``,
``prepare_dense``, ``make_vg_dense``, ``stack_chains``, ``unstack_chains``).
The data loop is unrolled over the rows with ``x`` and ``y`` as constants:
zero inputs drop their weight terms, unit inputs become adds, and the BCE
head is ``y*z - softplus(z)`` on the logit with one ``exp(-|z|)`` shared by
the softplus and the sigmoid (mlp_dense.py:124-141).

One program, two readings. ``_program`` writes the body once, over values
that are either tensors or symbols: ``make_vg_dense`` runs it on a tuple of
``P`` same-shape tensors (the plain version), and ``dense_source`` runs it on
symbols and emits the same operations, in the same order, as the CUDA
header ``dense_body.cuh`` that the dense kernels
(``csrc/resident_hmc_dense.cu``, ``csrc/resident_walk_dense.cu``) include.
``nvcc`` without fast math would not fold ``0 * w`` (it is NaN for an
infinite ``w``), so the dropped terms are left out by the program itself.
``dense_work`` counts the operations of the emitted code, for the kernels'
bounds.

The TPU's ``[P*8, C/8]`` chain tiles (chain ``c = s*(C/8) + column``) are,
byte for byte, the ``[P, C]`` chain-minor layout the CUDA kernels use, so
``stack_chains`` and ``unstack_chains`` are reshapes.
"""

import math

import numpy as np
import torch

from eeyore_tpu_torch.ops.mlp_math import extract_arch

MAX_DENSE_ROWS = 32


def prepare_dense(model, x, y):
    """Per-model constants of the dense body: the data as float64 arrays and
    the prior's moments per parameter; raises above ``MAX_DENSE_ROWS`` rows."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape[0] > MAX_DENSE_ROWS:
        raise ValueError(
            f"the dense body unrolls the data loop; {x.shape[0]} rows "
            f"> MAX_DENSE_ROWS={MAX_DENSE_ROWS} (use ops/mlp_math.py)")
    P = model.num_params
    scale = model.prior.scale.detach().cpu().numpy().astype(np.float64).reshape(P)
    loc = model.prior.loc.detach().cpu().numpy().astype(np.float64).reshape(P)
    ivar = 1.0 / scale ** 2
    prior_const = float(np.sum(-np.log(scale) - 0.5 * math.log(2.0 * math.pi)))
    temperature = 1.0 if model.temperature is None else float(model.temperature)
    return x, y, loc, ivar, prior_const, temperature


def _f32(c):
    """A constant as the float32 value the kernels use, as a Python float."""
    return float(np.float32(c))


def _program(model, x, y, with_grad, theta, ops):
    """The dense body over ``theta`` (P values): ``val``, or ``(val, grads)``
    with ``with_grad``. ``ops`` supplies the functions and the zero value; the
    arithmetic is Python's operators. The order of every operation follows
    ``eeyore_tpu/ops/mlp_dense.py:77-211``."""
    dims, bias, loss_kind, layer_offsets = extract_arch(model)
    x, y, loc, ivar, prior_const, temperature = prepare_dense(model, x, y)
    n = x.shape[0]
    num_layers = len(dims) - 1
    k_out = dims[-1]
    P = model.num_params
    temp = float(temperature)
    zeros = ops.zeros()

    def w_idx(l, j, i):
        return layer_offsets[l][0] + j * dims[l] + i

    def b_idx(l, j):
        return layer_offsets[l][1] + j

    def fma_const(acc, c, tile):
        """acc + c * tile with the constant folded."""
        if c == 0.0:
            return acc
        if c == 1.0:
            return tile if acc is None else acc + tile
        scaled = _f32(c) * tile
        return scaled if acc is None else acc + scaled

    log_lik = None
    g = [None] * P  # the data term's gradient; the prior's is added at the end

    def g_add(p, term):
        g[p] = term if g[p] is None else g[p] + term

    for d in range(n):
        acts = []  # hidden activations per layer
        prev_const = [float(v) for v in x[d]]
        zs_out = []
        for l in range(num_layers):
            z_l = []
            for j in range(dims[l + 1]):
                acc = theta[b_idx(l, j)] if bias[l] else None
                if l == 0:
                    for i in range(dims[0]):
                        c = prev_const[i]
                        if c == 0.0:
                            continue
                        term = theta[w_idx(0, j, i)]
                        if c != 1.0:
                            term = _f32(c) * term
                        acc = term if acc is None else acc + term
                else:
                    for i in range(dims[l]):
                        term = acts[l - 1][i] * theta[w_idx(l, j, i)]
                        acc = term if acc is None else acc + term
                z_l.append(zeros if acc is None else acc)
            if l < num_layers - 1:
                acts.append([ops.sigmoid(z) for z in z_l])
            zs_out = z_l

        if loss_kind == "bce":
            deltas = []
            for j in range(k_out):
                z = zs_out[j]
                yv = float(y[d, j])
                ll_j = fma_const(None, yv, z)
                # softplus and sigmoid share one exp(-|z|)
                e = ops.exp(-ops.abs(z))
                sp = ops.max0(z) + ops.log1p(e)
                ll_j = -sp if ll_j is None else ll_j - sp
                log_lik = ll_j if log_lik is None else log_lik + ll_j
                if with_grad:
                    inv = 1.0 / (1.0 + e)
                    sig = ops.where_nonneg(z, inv, e * inv)
                    deltas.append(_f32(yv) - sig)
        else:
            zmax = zs_out[0]
            for j in range(1, k_out):
                zmax = ops.maximum(zmax, zs_out[j])
            sumexp = None
            for j in range(k_out):
                e = ops.exp(zs_out[j] - zmax)
                sumexp = e if sumexp is None else sumexp + e
            lse = zmax + ops.log(sumexp)
            picked = None
            for j in range(k_out):
                picked = fma_const(picked, float(y[d, j]), zs_out[j])
            ll_d = (picked if picked is not None else zeros) - lse
            log_lik = ll_d if log_lik is None else log_lik + ll_d
            if with_grad:
                deltas = [_f32(float(y[d, j])) - ops.exp(zs_out[j] - lse)
                          for j in range(k_out)]

        if not with_grad:
            continue

        for l in reversed(range(num_layers)):
            for j in range(dims[l + 1]):
                if l == 0:
                    for i in range(dims[0]):
                        c = prev_const[i]
                        if c == 0.0:
                            continue
                        g_add(w_idx(0, j, i), deltas[j] if c == 1.0 else _f32(c) * deltas[j])
                else:
                    for i in range(dims[l]):
                        g_add(w_idx(l, j, i), deltas[j] * acts[l - 1][i])
                if bias[l]:
                    g_add(b_idx(l, j), deltas[j])
            if l > 0:
                new_deltas = []
                for i in range(dims[l]):
                    s = None
                    for j in range(dims[l + 1]):
                        term = deltas[j] * theta[w_idx(l, j, i)]
                        s = term if s is None else s + term
                    a = acts[l - 1][i]
                    new_deltas.append(s * (a * (1.0 - a)))
                deltas = new_deltas

    val = log_lik if log_lik is not None else zeros
    for p in range(P):
        diff = theta[p] - _f32(loc[p]) if loc[p] != 0.0 else theta[p]
        val = val - (_f32(0.5 * ivar[p]) * diff) * diff
    lp = _f32(prior_const)
    val = (val + lp) if temp == 1.0 else _f32(temp) * (val + lp)
    if not with_grad:
        return val

    grads = []
    for p in range(P):
        diff = theta[p] - _f32(loc[p]) if loc[p] != 0.0 else theta[p]
        gp = -_f32(ivar[p]) * diff
        if g[p] is not None:
            gp = g[p] + gp
        if temp != 1.0:
            gp = _f32(temp) * gp
        grads.append(gp)
    return val, tuple(grads)


class _TorchOps:
    def __init__(self, like):
        self.like = like

    def zeros(self):
        return torch.zeros_like(self.like)

    exp = staticmethod(torch.exp)
    log = staticmethod(torch.log)
    log1p = staticmethod(torch.log1p)
    abs = staticmethod(torch.abs)
    maximum = staticmethod(torch.maximum)
    sigmoid = staticmethod(torch.sigmoid)

    @staticmethod
    def max0(z):
        return torch.clamp(z, min=0.0)

    @staticmethod
    def where_nonneg(z, a, b):
        return torch.where(z >= 0, a, b)


def make_vg_dense(model, x, y, with_grad=True):
    """Build ``vg(theta) -> (val, grads)``: ``theta`` is a tuple of P
    same-shape float32 tensors (one per parameter, chains along their
    elements), ``val`` a tensor of that shape and ``grads`` a tuple of P
    of them. With ``with_grad=False`` it returns ``val`` only. Raises above
    ``MAX_DENSE_ROWS`` rows."""
    prepare_dense(model, x, y)
    P = model.num_params

    def vg(theta):
        if len(theta) != P:
            raise ValueError(f"theta has {len(theta)} tiles, the model {P} parameters")
        return _program(model, x, y, with_grad, tuple(theta), _TorchOps(theta[0]))

    return vg


# ---- the same program as CUDA C++ ----

def _literal(c):
    """Exact float32 literal (hex, C++17)."""
    c = _f32(c)
    text = f"{float.hex(abs(c))}f"
    return f"(-{text})" if c < 0 or (c == 0.0 and math.copysign(1.0, c) < 0) else text


class _Emitter:
    """Collects the statements of one function, counting operations: an
    add, subtract, multiply, negation, max, abs or select is one f32
    operation; exp, log and log1p are one special-function operation each, a
    division one reciprocal on that unit and one multiply."""

    def __init__(self):
        self.lines = []
        self.ops = 0
        self.sfu = 0

    def emit(self, expr, ops=1, sfu=0):
        self.ops += ops
        self.sfu += sfu
        name = f"t{len(self.lines)}"
        self.lines.append(f"  const float {name} = {expr};")
        return _Sym(self, name)


def _expr(v):
    return v.name if isinstance(v, _Sym) else _literal(v)


class _Sym:
    """A float value of the emitted code; arithmetic emits a statement."""

    def __init__(self, em, name):
        self.em = em
        self.name = name

    def _bin(self, other, op, swap=False):
        a, b = _expr(self), _expr(other)
        if swap:
            a, b = b, a
        return self.em.emit(f"{a} {op} {b}", ops=1, sfu=1 if op == "/" else 0)

    def __add__(self, o):
        return self._bin(o, "+")

    def __radd__(self, o):
        return self._bin(o, "+", swap=True)

    def __sub__(self, o):
        return self._bin(o, "-")

    def __rsub__(self, o):
        return self._bin(o, "-", swap=True)

    def __mul__(self, o):
        return self._bin(o, "*")

    def __rmul__(self, o):
        return self._bin(o, "*", swap=True)

    def __truediv__(self, o):
        return self._bin(o, "/")

    def __rtruediv__(self, o):
        return self._bin(o, "/", swap=True)

    def __neg__(self):
        return self.em.emit(f"-{self.name}")


class _SymOps:
    def __init__(self, em):
        self.em = em

    def zeros(self):
        return self.em.emit("0.0f", ops=0)

    def exp(self, a):
        return self.em.emit(f"expf({_expr(a)})", ops=0, sfu=1)

    def log(self, a):
        return self.em.emit(f"logf({_expr(a)})", ops=0, sfu=1)

    def log1p(self, a):
        return self.em.emit(f"log1pf({_expr(a)})", ops=0, sfu=1)

    def abs(self, a):
        return self.em.emit(f"fabsf({_expr(a)})")

    def maximum(self, a, b):
        return self.em.emit(f"fmaxf({_expr(a)}, {_expr(b)})")

    def max0(self, a):
        return self.em.emit(f"fmaxf({_expr(a)}, 0.0f)")

    def sigmoid(self, a):
        # as mlp_vg.cuh: 1 / (1 + exp(-z))
        return self.em.emit(f"1.0f / (1.0f + expf(-{_expr(a)}))", ops=3, sfu=2)

    def where_nonneg(self, z, a, b):
        return self.em.emit(f"{_expr(z)} >= 0.0f ? {_expr(a)} : {_expr(b)}")


def _emit(model, x, y, with_grad):
    em = _Emitter()
    theta = tuple(_Sym(em, f"th[{p}]") for p in range(model.num_params))
    out = _program(model, x, y, with_grad, theta, _SymOps(em))
    return em, out


def dense_source(model, x, y):
    """The text of ``dense_body.cuh`` for ``model`` and the data ``(x, y)``:
    ``dense_body::v(th)`` (value only) and ``dense_body::vg(th, g)`` (value,
    gradient into ``g``), the operations of ``make_vg_dense`` in its order."""
    P = model.num_params
    parts = ["// Generated by eeyore_tpu_torch/ops/mlp_dense.py::dense_source for one model",
             "// and dataset; the data are constants of the code. Do not edit.",
             "#pragma once", "", "namespace dense_body {", "",
             f"constexpr int kP = {P};", ""]
    em, val = _emit(model, x, y, with_grad=False)
    parts += [f"__device__ __forceinline__ float v(const float (&th)[{P}]) {{", *em.lines,
              f"  return {_expr(val)};", "}", ""]
    em, (val, grads) = _emit(model, x, y, with_grad=True)
    parts += [f"__device__ __forceinline__ float vg(const float (&th)[{P}], float (&g)[{P}]) {{",
              *em.lines, *(f"  g[{p}] = {_expr(gp)};" for p, gp in enumerate(grads)),
              f"  return {_expr(val)};", "}", "", "}  // namespace dense_body", ""]
    return "\n".join(parts)


def dense_work(model, x, y, with_grad):
    """(f32 operations, special-function operations) of one evaluation of
    the emitted body, counted from the code."""
    em, _ = _emit(model, x, y, with_grad)
    return em.ops, em.sfu


def stack_chains(theta0s):
    """[C, P] chain-major -> [P*8, C/8] dense tiles, chain c = s*(C/8) +
    column (s the sublane). C must be a multiple of 8."""
    C, P = theta0s.shape
    if C % 8:
        raise ValueError(f"dense layout needs a multiple of 8 chains, got {C}")
    return theta0s.to(torch.float32).T.reshape(P * 8, C // 8)


def unstack_chains(dense, num_params):
    """[P*8, lanes] (or [..., P*8, lanes]) -> [..., C, P], as a view."""
    lanes = dense.shape[-1]
    lead = dense.shape[:-2]
    return dense.reshape(*lead, num_params, 8 * lanes).transpose(-1, -2)
