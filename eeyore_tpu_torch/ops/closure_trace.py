"""Straight-line CUDA for a log-density closure, traced from PyTorch.

The SMC mutation kernel of a ``DistributionModel`` target
(``csrc/resident_smc_closure.cu``) evaluates the user's closure on the card.
The JAX package traces the closure into its Pallas kernel
(``eeyore_tpu/ops/resident_smc.py:215-237``, ``_eval_jaxpr_ew_dots`` at
``:156``); here ``make_fx`` traces the closure's value and gradient for one
particle, ``theta [P]``, to a graph of ATen operations, and ``lower`` turns
the graph into scalar statements. Each node's value is a numpy array of
operands (a statement's name or a constant) of the node's shape, so views,
broadcasts and reductions are numpy indexing of those arrays, and every
elementwise operation, reduction term and product term becomes one
statement. Constants fold on the host in float32, as the card would compute
them. ``cuda_source`` prints two programs, value only and value with
gradient, as the device functions of one particle that the kernel includes;
``work`` counts their operations for the kernel's bound.

Only the operations in ``_LOWER`` lower: the elementwise and reduction
operations, views and products of a closure of small static shapes in
float32. Any other raises and names the operation, as the TPU kernel fails to
compile a closure that Mosaic cannot lower.
"""

import math
import operator

import numpy as np
import torch

aten = torch.ops.aten

# The statements' operations: numpy's float32 version (constant folding, and
# any interpreter of a program), the C expression, and the count as
# (f32 operations, special-function operations), as mlp_dense.py counts: a
# division or reciprocal is one reciprocal on that unit and one multiply.
_OPS = {
    "add": (np.add, "({0} + {1})", (1, 0)),
    "sub": (np.subtract, "({0} - {1})", (1, 0)),
    "mul": (np.multiply, "({0} * {1})", (1, 0)),
    "div": (np.divide, "({0} / {1})", (1, 1)),
    "pow": (np.power, "powf({0}, {1})", (1, 2)),
    "max": (np.maximum, "cl_max({0}, {1})", (1, 0)),
    "min": (np.minimum, "cl_min({0}, {1})", (1, 0)),
    "logaddexp": (np.logaddexp, "cl_logaddexp({0}, {1})", (5, 2)),
    "neg": (np.negative, "(-{0})", (1, 0)),
    "exp": (np.exp, "expf({0})", (0, 1)),
    "log": (np.log, "logf({0})", (0, 1)),
    "log1p": (np.log1p, "log1pf({0})", (0, 1)),
    "expm1": (np.expm1, "expm1f({0})", (0, 1)),
    "sqrt": (np.sqrt, "sqrtf({0})", (0, 1)),
    "abs": (np.abs, "fabsf({0})", (1, 0)),
    "tanh": (np.tanh, "tanhf({0})", (3, 2)),
    "sin": (np.sin, "sinf({0})", (0, 1)),
    "cos": (np.cos, "cosf({0})", (0, 1)),
    "sigmoid": (lambda a: np.float32(1) / (np.float32(1) + np.exp(-a)),
                "(1.0f / (1.0f + expf(-{0})))", (3, 2)),
    "float": (lambda a: np.asarray(a, np.float32), "static_cast<float>({0})", (1, 0)),
    "lt": (np.less, "({0} < {1})", (1, 0)),
    "le": (np.less_equal, "({0} <= {1})", (1, 0)),
    "gt": (np.greater, "({0} > {1})", (1, 0)),
    "ge": (np.greater_equal, "({0} >= {1})", (1, 0)),
    "eq": (np.equal, "({0} == {1})", (1, 0)),
    "ne": (np.not_equal, "({0} != {1})", (1, 0)),
    "and": (np.logical_and, "({0} && {1})", (1, 0)),
    "or": (np.logical_or, "({0} || {1})", (1, 0)),
    "not": (np.logical_not, "(!{0})", (1, 0)),
    "where": (np.where, "({0} ? {1} : {2})", (1, 0)),
}
_BOOL_OPS = {"lt", "le", "gt", "ge", "eq", "ne", "and", "or", "not"}
# a program larger than this many statements is refused: the kernel holds
# every live value of one particle in registers
MAX_STATEMENTS = 20000

_HELPERS = """\
// torch.maximum / torch.minimum: NaN propagates (fmaxf would drop it)
__device__ __forceinline__ float cl_max(float a, float b) {
  return (a != a || b != b) ? NAN : (a > b ? a : b);
}
__device__ __forceinline__ float cl_min(float a, float b) {
  return (a != a || b != b) ? NAN : (a < b ? a : b);
}
// torch.logaddexp as PyTorch computes it on the card
__device__ __forceinline__ float cl_logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = a > b ? a : b;
  return m + log1pf(expf(-fabsf(a - b)));
}"""


def fold(op, *args):
    """``op`` on float32 / bool numpy scalars or arrays, as the card computes
    it (no warnings: an overflow is an inf there too)."""
    with np.errstate(all="ignore"):
        out = np.asarray(_OPS[op][0](*args))
    out = out.astype(np.bool_ if op in _BOOL_OPS else np.float32)
    return out[()] if out.ndim == 0 else out


class Program:
    """Straight-line statements ``(name, op, args)``; an argument is a
    statement's name, ``th[p]``, or a numpy float32 / bool constant.
    ``outputs`` are such operands."""

    def __init__(self, num_params):
        self.num_params = num_params
        self.statements = []
        self.kinds = {f"th[{p}]": "f" for p in range(num_params)}
        self.outputs = []

    def kind(self, a):
        if isinstance(a, str):
            return self.kinds[a]
        return "b" if isinstance(a, (bool, np.bool_)) else "f"

    def emit(self, op, *args):
        if op == "where":
            args = (args[0], self.as_float(args[1]), self.as_float(args[2]))
        elif op not in _BOOL_OPS and op != "float":
            args = tuple(self.as_float(a) for a in args)
        if not any(isinstance(a, str) for a in args):
            return fold(op, *args)
        if len(self.statements) >= MAX_STATEMENTS:
            raise ValueError(f"the closure lowers to more than {MAX_STATEMENTS} statements")
        name = f"t{len(self.statements)}"
        self.statements.append((name, op, args))
        self.kinds[name] = "b" if op in _BOOL_OPS else "f"
        return name

    def as_float(self, a):
        if self.kind(a) == "f":
            return a if isinstance(a, str) else np.float32(a)
        return self.emit("float", a) if isinstance(a, str) else np.float32(a)


def _obj(shape, fill):
    out = np.empty(shape, dtype=object)
    out.fill(fill)
    return out


def _operands(values, shape):
    """An operand array of ``shape`` holding ``values`` in row-major order."""
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out.reshape(shape)


def _scalar(a):
    """A Python or numpy scalar as a 0-d operand array."""
    c = np.bool_(a) if isinstance(a, (bool, np.bool_)) else np.float32(a)
    return _obj((), c)


def _elementwise(prog, op, *arrays):
    arrays = np.broadcast_arrays(*arrays)
    out = np.empty(arrays[0].shape, dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = prog.emit(op, *(a[idx] for a in arrays))
    return out


def _reduce(prog, op, a, dims, keepdim):
    """``op`` ("add", "max" or "min") over ``dims`` (all when empty), in
    index order."""
    dims = tuple(d % a.ndim for d in dims) if dims else tuple(range(a.ndim))
    keep = [d for d in range(a.ndim) if d not in dims]
    moved = np.transpose(a, keep + list(dims))
    flat = moved.reshape(moved.shape[:len(keep)] + (-1,))
    out = np.empty(flat.shape[:-1], dtype=object)
    for idx in np.ndindex(out.shape):
        terms = flat[idx]
        acc = terms[0] if terms.size else np.float32(0)
        for t in terms[1:]:
            acc = prog.emit(op, acc, t)
        out[idx] = acc
    if keepdim:
        out = out.reshape([1 if d in dims else a.shape[d] for d in range(a.ndim)])
    return out


def _matmul(prog, a, b):
    """``a @ b`` for 1-d and 2-d (and batched) operands."""
    a2 = a[None, :] if a.ndim == 1 else a
    b2 = b[:, None] if b.ndim == 1 else b
    prod = _elementwise(prog, "mul", a2[..., :, :, None], b2[..., None, :, :])
    out = _reduce(prog, "add", prod, (-2,), False)
    if a.ndim == 1:
        out = out[..., 0, :]
    if b.ndim == 1:
        out = out[..., 0]
    return out


def _pow_scalar(prog, a, e):
    """``a ** e`` as PyTorch's kernel special-cases the exponent."""
    e = float(e)
    if e == 1.0:
        return a
    if e == 2.0:
        return _elementwise(prog, "mul", a, a)
    if e == 3.0:
        return _elementwise(prog, "mul", _elementwise(prog, "mul", a, a), a)
    if e == 0.5:
        return _elementwise(prog, "sqrt", a)
    if e == -1.0:
        return _elementwise(prog, "div", _scalar(1.0), a)
    if e == -2.0:
        return _elementwise(prog, "div", _scalar(1.0), _elementwise(prog, "mul", a, a))
    return _elementwise(prog, "pow", a, _scalar(e))


def _with_alpha(prog, b, alpha):
    return b if alpha == 1 else _elementwise(prog, "mul", b, _scalar(alpha))


def _binary(op):
    return lambda prog, n, a, b, **kw: _elementwise(prog, op, a, b)


def _unary(op):
    return lambda prog, n, a, **kw: _elementwise(prog, op, a)


def _div(prog, n, a, b, rounding_mode=None):
    if rounding_mode is not None:
        raise ValueError(f"the closure kernel cannot lower division with rounding_mode="
                         f"{rounding_mode!r}")
    return _elementwise(prog, "div", a, b)


def _reshape(prog, n, a, *args, **kw):
    return a.reshape(n.meta["val"].shape)


def _fill(value):
    return lambda prog, n, *args, **kw: _obj(tuple(n.meta["val"].shape), np.float32(value))


def _sum(prog, n, a, dims=None, keepdim=False, dtype=None):
    return _reduce(prog, "add", a, tuple(dims or ()), keepdim)


def _mean(prog, n, a, dims=None, keepdim=False, dtype=None):
    total = _reduce(prog, "add", a, tuple(dims or ()), keepdim)
    count = a.size // max(1, total.size)
    return _elementwise(prog, "div", total, _scalar(count))


def _slice(prog, n, a, dim=0, start=None, end=None, step=1):
    index = [slice(None)] * a.ndim
    index[dim] = slice(start, end, step)
    return a[tuple(index)]


def _into_zeros(n, grad, index):
    """The ``*_backward`` of a slice or select: zeros of the input's shape
    with ``grad`` at ``index``."""
    out = _obj(tuple(n.meta["val"].shape), np.float32(0))
    grad = np.asarray(grad, dtype=object)
    out[index] = grad[()] if grad.ndim == 0 else grad
    return out


def _slice_backward(prog, n, grad, sizes, dim, start, end, step):
    index = [slice(None)] * len(sizes)
    index[dim] = slice(start, end, step)
    return _into_zeros(n, grad, tuple(index))


def _select_backward(prog, n, grad, sizes, dim, index):
    at = [slice(None)] * len(sizes)
    at[dim] = index
    return _into_zeros(n, grad, tuple(at))


def _sign(prog, n, a):
    """torch.sign: 1, -1, or the value itself (0, -0 and NaN)."""
    negative = _elementwise(prog, "where", _elementwise(prog, "lt", a, _scalar(0.0)),
                            _scalar(-1.0), a)
    return _elementwise(prog, "where", _elementwise(prog, "gt", a, _scalar(0.0)), _scalar(1.0),
                        negative)


def _clamp(prog, n, a, lo=None, hi=None):
    if lo is not None:
        a = _elementwise(prog, "max", a, lo if isinstance(lo, np.ndarray) else _scalar(lo))
    if hi is not None:
        a = _elementwise(prog, "min", a, hi if isinstance(hi, np.ndarray) else _scalar(hi))
    return a


_LOWER = {
    aten.add: lambda prog, n, a, b, alpha=1: _elementwise(prog, "add", a,
                                                          _with_alpha(prog, b, alpha)),
    aten.sub: lambda prog, n, a, b, alpha=1: _elementwise(prog, "sub", a,
                                                          _with_alpha(prog, b, alpha)),
    aten.rsub: lambda prog, n, a, b, alpha=1: _elementwise(prog, "sub", b,
                                                           _with_alpha(prog, a, alpha)),
    aten.mul: _binary("mul"),
    aten.div: _div,
    aten.maximum: _binary("max"),
    aten.minimum: _binary("min"),
    aten.logaddexp: _binary("logaddexp"),
    aten.lt: _binary("lt"), aten.le: _binary("le"), aten.gt: _binary("gt"),
    aten.ge: _binary("ge"), aten.eq: _binary("eq"), aten.ne: _binary("ne"),
    aten.logical_and: _binary("and"), aten.logical_or: _binary("or"),
    aten.logical_not: _unary("not"),
    aten.where: lambda prog, n, c, a, b: _elementwise(prog, "where", c, a, b),
    aten.neg: _unary("neg"), aten.exp: _unary("exp"), aten.log: _unary("log"),
    aten.log1p: _unary("log1p"), aten.expm1: _unary("expm1"), aten.sqrt: _unary("sqrt"),
    aten.abs: _unary("abs"), aten.tanh: _unary("tanh"), aten.sigmoid: _unary("sigmoid"),
    aten.sin: _unary("sin"), aten.cos: _unary("cos"),
    aten.rsqrt: lambda prog, n, a: _elementwise(prog, "div", _scalar(1.0),
                                                _elementwise(prog, "sqrt", a)),
    aten.reciprocal: lambda prog, n, a: _elementwise(prog, "div", _scalar(1.0), a),
    aten.pow: lambda prog, n, a, e: (_pow_scalar(prog, a, e) if not isinstance(e, np.ndarray)
                                     else _elementwise(prog, "pow", _scalar_arg(a), e)),
    aten.clamp: _clamp,
    aten.sum: _sum,
    aten.mean: _mean,
    aten.amax: lambda prog, n, a, dims=(), keepdim=False: _reduce(prog, "max", a, tuple(dims),
                                                                  keepdim),
    aten.amin: lambda prog, n, a, dims=(), keepdim=False: _reduce(prog, "min", a, tuple(dims),
                                                                  keepdim),
    aten.dot: lambda prog, n, a, b: _matmul(prog, a, b),
    aten.mm: lambda prog, n, a, b: _matmul(prog, a, b),
    aten.view: _reshape, aten.unsqueeze: _reshape, aten.squeeze: _reshape,
    # an in-place view, which functionalization keeps (matmul's 1-d case):
    # later uses read the node's output, so it is its out-of-place view
    aten.squeeze_: _reshape,
    aten.expand: lambda prog, n, a, *args, **kw: np.broadcast_to(a, n.meta["val"].shape),
    aten.permute: lambda prog, n, a, dims: np.transpose(a, dims),
    aten.t: lambda prog, n, a: a.T,
    aten.transpose: lambda prog, n, a, d0, d1: np.swapaxes(a, d0, d1),
    aten.select: lambda prog, n, a, dim, index: np.take(a, index, axis=dim),
    aten.slice: _slice,
    aten.slice_backward: _slice_backward,
    aten.select_backward: _select_backward,
    aten.masked_fill: lambda prog, n, a, mask, value: _elementwise(
        prog, "where", mask, value if isinstance(value, np.ndarray) else _scalar(value), a),
    aten.sgn: _sign,
    aten.cat: lambda prog, n, arrays, dim=0: np.concatenate(arrays, axis=dim),
    aten.stack: lambda prog, n, arrays, dim=0: np.stack(arrays, axis=dim),
    aten.detach: lambda prog, n, a: a, aten.lift_fresh_copy: lambda prog, n, a: a,
    aten._to_copy: lambda prog, n, a, **kw: (_elementwise(prog, "float", a)
                                             if n.meta["val"].dtype == torch.float32 else a),
    aten.ones_like: _fill(1.0), aten.zeros_like: _fill(0.0),
    aten.full_like: lambda prog, n, a, value, **kw: _fill(value)(prog, n),
    aten.scalar_tensor: lambda prog, n, value, **kw: _fill(value)(prog, n),
}


def _arg(env, a):
    if isinstance(a, torch.fx.Node):
        return env[a]
    if isinstance(a, (list, tuple)):
        if any(isinstance(x, torch.fx.Node) for x in a):
            return [_arg(env, x) for x in a]
        return list(a)
    return a


def _scalar_arg(a):
    """Scalars that meet a tensor elementwise become 0-d operand arrays."""
    return _scalar(a) if isinstance(a, (float, int, bool)) else a


_SCALAR_OPERANDS = {aten.add, aten.sub, aten.rsub, aten.mul, aten.div, aten.maximum,
                    aten.minimum, aten.logaddexp, aten.lt, aten.le, aten.gt, aten.ge, aten.eq,
                    aten.ne, aten.where, aten.logical_and, aten.logical_or}


def lower(gm, num_params):
    """The ``Program`` of a graph traced by ``make_fx`` from a function of
    ``theta [num_params]`` whose outputs are tensors; ``outputs`` are their
    operands, flattened in order."""
    prog = Program(num_params)
    env = {}
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            env[n] = np.array([f"th[{p}]" for p in range(num_params)], dtype=object)
            continue
        if n.op == "output":
            for out in n.args[0]:
                prog.outputs.extend(np.asarray(env[out], dtype=object).reshape(-1).tolist())
            continue
        if n.op == "get_attr":
            value = getattr(gm, n.target).detach().cpu()
            if value.dtype not in (torch.float32, torch.float64, torch.bool):
                raise ValueError(f"the closure kernel cannot hold a {value.dtype} constant")
            dtype = np.bool_ if value.dtype == torch.bool else np.float32
            env[n] = _operands([dtype(v) for v in value.numpy().reshape(-1)],
                               tuple(value.shape))
            continue
        target = n.target
        val = n.meta.get("val")
        if n.op != "call_function" or target is operator.getitem or not isinstance(
                val, torch.Tensor) or target.overloadpacket not in _LOWER:
            raise ValueError(f"the closure kernel cannot lower {target}")
        # integers (the tie counts of an amax's gradient) are small counts,
        # exact in float32
        if val.dtype not in (torch.float32, torch.bool, torch.int32, torch.int64):
            raise ValueError(f"the closure kernel computes in float32; {target} gives "
                             f"{val.dtype}")
        packet = target.overloadpacket
        args = [_arg(env, a) for a in n.args]
        kwargs = {k: _arg(env, a) for k, a in n.kwargs.items()
                  if k not in ("dtype", "layout", "device", "pin_memory", "memory_format",
                               "non_blocking")}
        if packet in _SCALAR_OPERANDS:
            args = [_scalar_arg(a) for a in args]
        out = np.asarray(_LOWER[packet](prog, n, *args, **kwargs), dtype=object)
        if out.shape != tuple(val.shape):
            raise ValueError(f"lowering {target} gave shape {out.shape}, not {tuple(val.shape)}")
        env[n] = out
    return prog


# Composite operations traced as their decompositions into the ones above.
_DECOMPOSED = (aten.logsumexp, aten.softplus, aten.softplus_backward, aten.sigmoid_backward,
               aten.tanh_backward, aten.log_sigmoid_forward, aten.log_sigmoid_backward)


def trace_split(ll_fn, lp_fn, num_params, with_grad, device="cpu"):
    """The ``Program`` of one particle's ``(ll, lp)`` (``with_grad``: also
    ``gll [P]`` and ``glp [P]``), traced on ``device`` with ``make_fx`` from
    the closures of ``theta [P]``, in-place operations functionalized."""
    from torch._decomp import get_decompositions
    from torch.fx.experimental.proxy_tensor import make_fx

    def split(th):
        if with_grad:
            gll, ll = torch.func.grad_and_value(ll_fn)(th)
            glp, lp = torch.func.grad_and_value(lp_fn)(th)
            return ll, lp, gll, glp
        return ll_fn(th), lp_fn(th)

    gm = make_fx(torch.func.functionalize(split, remove="mutations"),
                 decomposition_table=get_decompositions(_DECOMPOSED))(
        torch.zeros(num_params, dtype=torch.float32, device=device))
    return lower(gm, num_params)


def _literal(c):
    """An exact float32 (hex, C++17) or bool literal."""
    if isinstance(c, (bool, np.bool_)):
        return "true" if c else "false"
    c = float(np.float32(c))
    if math.isnan(c):
        return "NAN"
    if math.isinf(c):
        return "INFINITY" if c > 0 else "(-INFINITY)"
    text = f"{float.hex(abs(c))}f"
    return f"(-{text})" if c < 0 or (c == 0.0 and math.copysign(1.0, c) < 0) else text


def _operand(a):
    return a if isinstance(a, str) else _literal(a)


def _body(prog):
    return [f"  const {'bool' if prog.kinds[name] == 'b' else 'float'} {name} = "
            f"{_OPS[op][1].format(*map(_operand, args))};" for name, op, args in prog.statements]


def cuda_source(prog_v, prog_vg):
    """The text of ``closure_body.cuh``: ``closure_body::v(th)`` -> (ll, lp)
    and ``closure_body::vg(th, gll, glp)`` -> (ll, lp) with the gradients,
    from the value-only and the value-and-gradient programs."""
    P = prog_v.num_params
    ll, lp = map(_operand, prog_v.outputs)
    parts = ["// Generated by eeyore_tpu_torch/ops/closure_trace.py::cuda_source from one",
             "// log-density closure and its base. Do not edit.", "#pragma once", "",
             "#include <math.h>", "", "namespace closure_body {", "", f"constexpr int kP = {P};",
             "", _HELPERS, "",
             "// (ll, lp) of one particle: ll = log target - log base, lp = log base",
             f"__device__ __forceinline__ float2 v(const float (&th)[{P}]) {{", *_body(prog_v),
             f"  return make_float2({ll}, {lp});", "}", ""]
    outs = list(map(_operand, prog_vg.outputs))
    parts += [f"__device__ __forceinline__ float2 vg(const float (&th)[{P}], float (&gll)[{P}], "
              f"float (&glp)[{P}]) {{", *_body(prog_vg),
              *(f"  gll[{p}] = {outs[2 + p]};" for p in range(P)),
              *(f"  glp[{p}] = {outs[2 + P + p]};" for p in range(P)),
              f"  return make_float2({outs[0]}, {outs[1]});", "}", "",
              "}  // namespace closure_body", ""]
    return "\n".join(parts)


def work(prog):
    """(f32 operations, special-function operations) of one run of the
    program, counted from its statements."""
    ops = sum(_OPS[op][2][0] for _, op, _ in prog.statements)
    sfu = sum(_OPS[op][2][1] for _, op, _ in prog.statements)
    return ops, sfu
