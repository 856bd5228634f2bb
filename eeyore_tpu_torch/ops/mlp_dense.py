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
bounds. Each generated header is the span ``eeyore.codegen``
(``utils/profiling.py``).

The TPU's ``[P*8, C/8]`` chain tiles (chain ``c = s*(C/8) + column``) are,
byte for byte, the ``[P, C]`` chain-minor layout the CUDA kernels use, so
``stack_chains`` and ``unstack_chains`` are reshapes.
"""

import math

import numpy as np
import torch

from eeyore_tpu_torch.ops.mlp_math import extract_arch
from eeyore_tpu_torch.utils.host import host_array
from eeyore_tpu_torch.utils.profiling import spanned

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
    scale = host_array(model.prior.scale).astype(np.float64).reshape(P)
    loc = host_array(model.prior.loc).astype(np.float64).reshape(P)
    ivar = 1.0 / scale ** 2
    prior_const = float(np.sum(-np.log(scale) - 0.5 * math.log(2.0 * math.pi)))
    temperature = 1.0 if model.temperature is None else float(model.temperature)
    return x, y, loc, ivar, prior_const, temperature


def _f32(c):
    """A constant as the float32 value the kernels use, as a Python float."""
    return float(np.float32(c))


class _Body:
    """The pieces of the dense body for one model and dataset, over values
    that ``ops`` supplies (tensors or symbols; the arithmetic is Python's
    operators), shared by the full body (``_program``) and the incremental
    Gibbs body (``_gibbs_program``) so that both run the same operations in
    the same order. That order follows ``eeyore_tpu/ops/mlp_dense.py:77-211``."""

    def __init__(self, model, x, y, ops):
        self.dims, self.bias, self.loss_kind, self.layer_offsets = extract_arch(model)
        (self.x, self.y, self.loc, self.ivar, self.prior_const,
         self.temperature) = prepare_dense(model, x, y)
        self.n = self.x.shape[0]
        self.num_layers = len(self.dims) - 1
        self.k_out = self.dims[-1]
        self.P = model.num_params
        self.ops = ops
        self.zeros = ops.zeros()

    def w_idx(self, l, j, i):
        return self.layer_offsets[l][0] + j * self.dims[l] + i

    def b_idx(self, l, j):
        return self.layer_offsets[l][1] + j

    def unit_z(self, theta, prev, l, j, xrow):
        """Pre-activation of unit j of layer l at a point whose inputs are
        ``xrow`` (constants, folded, or values of the lane body); ``prev``
        holds layer l's input activations there."""
        acc = theta[self.b_idx(l, j)] if self.bias[l] else None
        for i in range(self.dims[l]):
            if l == 0:
                term = _times(xrow[i], theta[self.w_idx(0, j, i)])
                if term is None:
                    continue
            else:
                term = prev[i] * theta[self.w_idx(l, j, i)]
            acc = term if acc is None else acc + term
        return self.zeros if acc is None else acc

    def bce_point(self, z, yv):
        """(y z - softplus(z), exp(-|z|)) of an output unit whose label is
        ``yv``; the sigmoid of the gradient reuses the exp."""
        ll = fma_const(None, yv, z)
        e = self.ops.exp(-self.ops.abs(z))
        sp = self.ops.max0(z) + self.ops.log1p(e)
        return (-sp if ll is None else ll - sp), e

    def ce_point(self, zs, yrow):
        """(log-likelihood, log-sum-exp) of the logits ``zs`` at a point
        whose one-hot labels are ``yrow``."""
        ops = self.ops
        zmax = zs[0]
        for j in range(1, self.k_out):
            zmax = ops.maximum(zmax, zs[j])
        sumexp = None
        for j in range(self.k_out):
            e = ops.exp(zs[j] - zmax)
            sumexp = e if sumexp is None else sumexp + e
        lse = zmax + ops.log(sumexp)
        picked = None
        for j in range(self.k_out):
            picked = fma_const(picked, yrow[j], zs[j])
        return (picked if picked is not None else self.zeros) - lse, lse

    def finish(self, theta, log_lik):
        """The tempered log-posterior from the summed log-likelihood."""
        val = log_lik if log_lik is not None else self.zeros
        for p in range(self.P):
            diff = theta[p] - _f32(self.loc[p]) if self.loc[p] != 0.0 else theta[p]
            val = val - (_f32(0.5 * self.ivar[p]) * diff) * diff
        lp = _f32(self.prior_const)
        temp = float(self.temperature)
        return (val + lp) if temp == 1.0 else _f32(temp) * (val + lp)


def _times(c, tile):
    """c * tile with a constant c folded: None for 0, tile for 1; a value of
    the lane body (a ``_Sym``) is a register operand, multiplied."""
    if isinstance(c, _Sym):
        return c * tile
    c = float(c)
    if c == 0.0:
        return None
    return tile if c == 1.0 else _f32(c) * tile


def _value(c):
    """A data constant as its float32 value, or a lane body's operand."""
    return c if isinstance(c, _Sym) else _f32(float(c))


def fma_const(acc, c, tile):
    """acc + c * tile with the constant folded (None: nothing yet)."""
    scaled = _times(c, tile)
    if scaled is None:
        return acc
    return scaled if acc is None else acc + scaled


def _data_terms(body, theta, rows, with_grad):
    """The log-likelihood of ``rows`` and (``with_grad``) its gradient, a
    list of P terms (None where no row reaches a coordinate), in the order of
    ``eeyore_tpu/ops/mlp_dense.py:77-211``. A row is (inputs, labels, mask):
    the dataset's constants with mask None, or a lane body's operands, whose
    mask (None on a slot that every lane fills) multiplies the row's terms."""
    ops = body.ops
    dims, bias, num_layers, k_out = body.dims, body.bias, body.num_layers, body.k_out
    log_lik = None
    g = [None] * body.P

    def g_add(p, term):
        g[p] = term if g[p] is None else g[p] + term

    def masked(term, m):
        return term if m is None else term * m

    for xrow, yrow, m in rows:
        acts = []  # hidden activations per layer
        prev = None
        for l in range(num_layers):
            z_l = [body.unit_z(theta, prev, l, j, xrow) for j in range(dims[l + 1])]
            if l < num_layers - 1:
                prev = [ops.sigmoid(z) for z in z_l]
                acts.append(prev)
        zs_out = z_l

        if body.loss_kind == "bce":
            deltas = []
            for j in range(k_out):
                ll_j, e = body.bce_point(zs_out[j], yrow[j])
                ll_j = masked(ll_j, m)
                log_lik = ll_j if log_lik is None else log_lik + ll_j
                if with_grad:
                    inv = 1.0 / (1.0 + e)
                    sig = ops.where_nonneg(zs_out[j], inv, e * inv)
                    deltas.append(masked(_value(yrow[j]) - sig, m))
        else:
            ll_d, lse = body.ce_point(zs_out, yrow)
            ll_d = masked(ll_d, m)
            log_lik = ll_d if log_lik is None else log_lik + ll_d
            if with_grad:
                deltas = [masked(_value(yrow[j]) - ops.exp(zs_out[j] - lse), m)
                          for j in range(k_out)]

        if not with_grad:
            continue

        for l in reversed(range(num_layers)):
            for j in range(dims[l + 1]):
                if l == 0:
                    for i in range(dims[0]):
                        term = _times(xrow[i], deltas[j])
                        if term is not None:
                            g_add(body.w_idx(0, j, i), term)
                else:
                    for i in range(dims[l]):
                        g_add(body.w_idx(l, j, i), deltas[j] * acts[l - 1][i])
                if bias[l]:
                    g_add(body.b_idx(l, j), deltas[j])
            if l > 0:
                new_deltas = []
                for i in range(dims[l]):
                    s = None
                    for j in range(dims[l + 1]):
                        term = deltas[j] * theta[body.w_idx(l, j, i)]
                        s = term if s is None else s + term
                    a = acts[l - 1][i]
                    new_deltas.append(s * (a * (1.0 - a)))
                deltas = new_deltas
    return log_lik, g


def _program(model, x, y, with_grad, theta, ops):
    """The dense body over ``theta`` (P values): ``val``, or ``(val, grads)``
    with ``with_grad``."""
    body = _Body(model, x, y, ops)
    log_lik, g = _data_terms(body, theta, [(body.x[d], body.y[d], None) for d in range(body.n)],
                             with_grad)
    val = body.finish(theta, log_lik)
    if not with_grad:
        return val

    temp = float(body.temperature)
    grads = []
    for p in range(body.P):
        diff = theta[p] - _f32(body.loc[p]) if body.loc[p] != 0.0 else theta[p]
        gp = -_f32(body.ivar[p]) * diff
        if g[p] is not None:
            gp = g[p] + gp
        if temp != 1.0:
            gp = _f32(temp) * gp
        grads.append(gp)
    return val, tuple(grads)


def gibbs_cache_keys(model, n):
    """The incremental Gibbs cache of a model on n points: hidden activations
    ``('a', l, j, d)``, then per output unit and point the BCE
    log-likelihood ``('ll', j, d)`` or the CE logit ``('z', j, d)``."""
    dims, _, loss_kind, _ = extract_arch(model)
    keys = tuple(("a", l, j, d) for l in range(len(dims) - 2) for j in range(dims[l + 1])
                 for d in range(n))
    return keys + tuple(("ll" if loss_kind == "bce" else "z", j, d)
                        for j in range(dims[-1]) for d in range(n))


def _gibbs_program(model, x, y, ops):
    """The incremental Gibbs body (``make_incremental_gibbs_dense``) over
    values that are tensors or symbols: ``(cache_keys, init, updates)``."""
    body = _Body(model, x, y, ops)
    dims, num_layers, n = body.dims, body.num_layers, body.n
    cache_keys = gibbs_cache_keys(model, n)
    key_pos = {k: i for i, k in enumerate(cache_keys)}

    def total_val(theta, cache):
        # d outer, j inner: the order of the full body's sum
        log_lik = None
        for d in range(n):
            if body.loss_kind == "bce":
                for j in range(body.k_out):
                    term = cache[key_pos[("ll", j, d)]]
                    log_lik = term if log_lik is None else log_lik + term
            else:
                term = body.ce_point([cache[key_pos[("z", j, d)]] for j in range(body.k_out)],
                                     body.y[d])[0]
                log_lik = term if log_lik is None else log_lik + term
        return body.finish(theta, log_lik)

    def forward(theta, cache, first_layer, units):
        cache = list(cache)
        for l in range(first_layer, num_layers):
            for j in (units if l == first_layer else range(dims[l + 1])):
                for d in range(n):
                    prev = (None if l == 0
                            else [cache[key_pos[("a", l - 1, i, d)]] for i in range(dims[l])])
                    z = body.unit_z(theta, prev, l, j, body.x[d])
                    if l < num_layers - 1:
                        cache[key_pos[("a", l, j, d)]] = ops.sigmoid(z)
                    elif body.loss_kind == "bce":
                        cache[key_pos[("ll", j, d)]] = body.bce_point(z, body.y[d, j])[0]
                    else:
                        cache[key_pos[("z", j, d)]] = z
        return tuple(cache)

    def init(theta):
        cache = forward(theta, [None] * len(cache_keys), 0, range(dims[1]))
        return total_val(theta, cache), cache

    def make_update(l, j):
        def update(theta, cache):
            cache = forward(theta, cache, l, (j,))
            return total_val(theta, cache), cache
        return update

    updates = {(l, j): make_update(l, j) for l in range(num_layers) for j in range(dims[l + 1])}
    return cache_keys, init, updates


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


def make_incremental_gibbs_dense(model, x, y):
    """Incremental value-only log-posterior for blocked Gibbs sweeps, on the
    dense body. Counterpart of ``eeyore_tpu/ops/mlp_dense.py::
    make_incremental_gibbs_dense`` (the contract of ``mlp_math.
    make_incremental_gibbs``): the cache holds one tensor per unit and data
    point (``gibbs_cache_keys``), ``init(theta) -> (val, cache)`` runs the
    full forward pass, ``updates[(l, j)](theta, cache) -> (val, new_cache)``
    recomputes unit (l, j) and everything downstream of it and returns the
    unchanged entries as the very same objects. ``theta`` is a tuple of P
    same-shape float32 tensors, as for ``make_vg_dense``, whose value-only
    body this equals bit for bit after any sequence of updates (the two are
    one program, ``_Body``). ``gibbs_dense_source`` emits the same operations
    as CUDA."""
    x, y = prepare_dense(model, x, y)[:2]
    P = model.num_params

    def program(theta):
        if len(theta) != P:
            raise ValueError(f"theta has {len(theta)} tiles, the model {P} parameters")
        return _gibbs_program(model, x, y, _TorchOps(theta[0]))

    def init(theta):
        return program(theta)[1](tuple(theta))

    def make_update(unit):
        def update(theta, cache):
            return program(theta)[2][unit](tuple(theta), cache)
        return update

    dims = extract_arch(model)[0]
    updates = {(l, j): make_update((l, j)) for l in range(len(dims) - 1)
               for j in range(dims[l + 1])}
    return gibbs_cache_keys(model, x.shape[0]), init, updates


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


@spanned("eeyore.codegen")
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


def lane_rows(n, lanes):
    """(slots, full): the rows a lane of ``lanes`` takes of ``n`` (lane l
    takes rows l, l + lanes, ...), and the slots that every lane fills; a
    later slot is a row on some lanes only, and the lane body masks it."""
    return -(-n // lanes), n // lanes


def _emit_lane(model, x, y, lanes, with_grad):
    """The data terms of one lane's rows as code: (emitter, log-likelihood,
    gradient terms), the rows' inputs, labels and masks read from the
    operand ``r`` (``LaneRows``)."""
    em = _Emitter()
    body = _Body(model, x, y, _SymOps(em))
    slots, full = lane_rows(body.n, lanes)
    theta = tuple(_Sym(em, f"th[{p}]") for p in range(body.P))
    rows = [([_Sym(em, f"r.x[{q}][{i}]") for i in range(body.dims[0])],
             [_Sym(em, f"r.y[{q}][{j}]") for j in range(body.k_out)],
             None if q < full else _Sym(em, f"r.m[{q}]")) for q in range(slots)]
    log_lik, g = _data_terms(body, theta, rows, with_grad)
    return em, (log_lik if log_lik is not None else body.zeros), g


def _array(values):
    """A nested C initializer of float32 literals."""
    if isinstance(values, (list, tuple, np.ndarray)):
        return "{" + ", ".join(_array(v) for v in values) + "}"
    return _literal(values)


@spanned("eeyore.codegen")
def dense_lane_source(model, x, y, lanes):
    """The text of ``dense_lanes.cuh`` for ``model``, the data ``(x, y)`` and
    ``lanes`` lanes a chain: ``dense_body::lane_v(th, r)`` and
    ``lane_vg(th, r, g)``, the partial log-likelihood (and its gradient
    into ``g``) of one lane's rows, lane l taking rows l, l + lanes, ...
    (``lane_rows``). The rows' inputs and labels are the operand ``r``, a
    ``LaneRows`` that the kernel loads into registers once, from the
    constants of the lane (``LaneBody::rows``), so the code is the same on
    every lane and a warp does not diverge; everything else is folded as in
    ``dense_source`` (the activations, the loss form, the shapes, no padding
    rows: a slot that is a row on some lanes only is masked). ``LaneBody``
    also carries the prior's constants, which ``lane_eval.cuh::
    LaneDenseEval`` applies to the coordinates each lane owns."""
    x, y, loc, ivar, prior_const, temperature = prepare_dense(model, x, y)
    n, P = x.shape[0], model.num_params
    if int(lanes) not in (1, 2, 4, 8, 16, 32) or lanes > n:
        raise ValueError(f"a chain takes 1, 2, 4, 8, 16 or 32 lanes and no more than the "
                         f"{n} data rows, not {lanes}")
    slots, _ = lane_rows(n, lanes)
    k_in, k_out = x.shape[1], y.shape[1]

    def lane_data(a, width):
        return [[a[l + q * lanes] if l + q * lanes < n else np.zeros(width)
                 for q in range(slots)] for l in range(lanes)]

    mask = [[1.0 if l + q * lanes < n else 0.0 for q in range(slots)] for l in range(lanes)]
    th = f"const float (&th)[{P}]"
    parts = ["// Generated by eeyore_tpu_torch/ops/mlp_dense.py::dense_lane_source for one",
             "// model, dataset and lane count; the data are constants of the code. Do not edit.",
             "#pragma once", "", "namespace dense_body {", "",
             f"constexpr int kLanes = {lanes};  // lanes a chain",
             f"constexpr int kSlots = {slots};  // rows a lane: lane l takes l, l + kLanes, ...",
             "",
             "// each lane's rows (inputs, labels, 1 where the slot holds a row) and the",
             "// prior's location and precision of each coordinate",
             f"__constant__ float kLaneX[{lanes}][{slots}][{k_in}] = {_array(lane_data(x, k_in))};",
             f"__constant__ float kLaneY[{lanes}][{slots}][{k_out}] = "
             f"{_array(lane_data(y, k_out))};",
             f"__constant__ float kLaneM[{lanes}][{slots}] = {_array(mask)};",
             f"__constant__ float kLoc[{P}] = {_array(loc)};",
             f"__constant__ float kIvar[{P}] = {_array(ivar)};", "",
             "struct LaneRows {", f"  float x[kSlots][{k_in}];", f"  float y[kSlots][{k_out}];",
             "  float m[kSlots];", "};", ""]
    em, val, _ = _emit_lane(model, x, y, lanes, with_grad=False)
    parts += [f"__device__ __forceinline__ float lane_v({th}, const LaneRows& r) {{", *em.lines,
              f"  return {_expr(val)};", "}", ""]
    em, val, g = _emit_lane(model, x, y, lanes, with_grad=True)
    parts += [f"__device__ __forceinline__ float lane_vg({th}, const LaneRows& r, "
              f"float (&g)[{P}]) {{", *em.lines,
              *(f"  g[{p}] = {'0.0f' if gp is None else _expr(gp)};" for p, gp in enumerate(g)),
              f"  return {_expr(val)};", "}", "",
              "// the interface of lane_eval.cuh::LaneDenseEval",
              "struct LaneBody {", "  using Rows = LaneRows;",
              f"  static constexpr float kPriorConst = {_literal(prior_const)};",
              f"  static constexpr float kTemperature = {_literal(temperature)};",
              "  static __device__ __forceinline__ Rows rows(int lane) {", "    Rows r;",
              "    for (int q = 0; q < kSlots; ++q) {",
              f"      for (int i = 0; i < {k_in}; ++i) r.x[q][i] = kLaneX[lane][q][i];",
              f"      for (int j = 0; j < {k_out}; ++j) r.y[q][j] = kLaneY[lane][q][j];",
              "      r.m[q] = kLaneM[lane][q];", "    }", "    return r;", "  }",
              "  static __device__ __forceinline__ float loc(int p) { return kLoc[p]; }",
              "  static __device__ __forceinline__ float ivar(int p) { return kIvar[p]; }",
              f"  static __device__ __forceinline__ float v({th}, const Rows& r) {{",
              "    return lane_v(th, r);", "  }",
              f"  static __device__ __forceinline__ float vg({th}, const Rows& r, "
              f"float (&g)[{P}]) {{", "    return lane_vg(th, r, g);", "  }", "};", "",
              "}  // namespace dense_body", ""]
    return "\n".join(parts)


def _emit_gibbs(model, x, y):
    """The incremental Gibbs program on symbols: (cache size, init's emitter
    and value, {unit: (emitter, value, {cache entry: new value})})."""
    P = model.num_params
    n = prepare_dense(model, x, y)[0].shape[0]
    size = len(gibbs_cache_keys(model, n))
    em = _Emitter()
    theta = tuple(_Sym(em, f"th[{p}]") for p in range(P))
    _, init, _ = _gibbs_program(model, x, y, _SymOps(em))
    val, cache = init(theta)
    out = (size, (em, val, dict(enumerate(cache))), {})
    dims = extract_arch(model)[0]
    for unit in ((l, j) for l in range(len(dims) - 1) for j in range(dims[l + 1])):
        em = _Emitter()
        theta = tuple(_Sym(em, f"th[{p}]") for p in range(P))
        old = tuple(_Sym(em, f"c[{i}]") for i in range(size))
        val, new = _gibbs_program(model, x, y, _SymOps(em))[2][unit](theta, old)
        out[2][unit] = (em, val, {i: v for i, (o, v) in enumerate(zip(old, new)) if v is not o})
    return out


@spanned("eeyore.codegen")
def gibbs_dense_source(model, x, y):
    """The text of ``dense_gibbs.cuh`` for ``model`` and the data ``(x, y)``:
    the cache size ``kCache``, ``init(th, c)`` (the full forward pass into the
    cache ``c``, returning the value) and, per unit U (its node block: layer
    by layer, node by node), ``update<U>(th, c, n)`` (the unit and everything
    downstream of it into ``n``, returning the value) and ``commit<U>(c, n)``
    (the entries ``update<U>`` wrote, copied into ``c``): the operations of
    ``make_incremental_gibbs_dense`` in its order."""
    P = model.num_params
    size, (em, val, cache), units = _emit_gibbs(model, x, y)
    th = f"const float (&th)[{P}]"
    parts = ["// Generated by eeyore_tpu_torch/ops/mlp_dense.py::gibbs_dense_source for one",
             "// model and dataset; the data are constants of the code. Do not edit.",
             "#pragma once", "", "namespace dense_gibbs {", "",
             f"constexpr int kCache = {size};", "",
             f"__device__ __forceinline__ float init({th}, float (&c)[{size}]) {{", *em.lines,
             *(f"  c[{i}] = {_expr(v)};" for i, v in cache.items()),
             f"  return {_expr(val)};", "}", "",
             f"template <int U> __device__ __forceinline__ float update({th}, "
             f"const float (&c)[{size}], float (&n)[{size}]);",
             f"template <int U> __device__ __forceinline__ void commit(float (&c)[{size}], "
             f"const float (&n)[{size}]);", ""]
    for u, (em, val, written) in enumerate(units.values()):
        parts += [f"template <> __device__ __forceinline__ float update<{u}>({th}, "
                  f"const float (&c)[{size}], float (&n)[{size}]) {{", *em.lines,
                  *(f"  n[{i}] = {_expr(v)};" for i, v in written.items()),
                  f"  return {_expr(val)};", "}",
                  f"template <> __device__ __forceinline__ void commit<{u}>(float (&c)[{size}], "
                  f"const float (&n)[{size}]) {{",
                  *(f"  c[{i}] = n[{i}];" for i in written), "}", ""]
    parts += ["}  // namespace dense_gibbs", ""]
    return "\n".join(parts)


def gibbs_dense_work(model, x, y):
    """{(l, j): (f32 operations, special-function operations)} of one
    incremental update of each unit, counted from the emitted code."""
    return {unit: (em.ops, em.sfu) for unit, (em, _, _) in _emit_gibbs(model, x, y)[2].items()}


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
