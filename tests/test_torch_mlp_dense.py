"""Port, dense body: ``ops/mlp_dense.py``. ``make_vg_dense`` (value only and
with gradient, BCE and CE) against the JAX package's ``make_vg_dense`` on the
same float32 tiles (rtol 2e-5, atol 2e-4, as tests/test_mlp_dense.py holds
the JAX body to autograd; the two differ only in the exp/log rounding of the
two libraries); the CUDA text ``dense_source`` emits, read back by a small
numpy interpreter, against ``make_vg_dense`` (the same operations in the same
order: 1e-6 relative), and its lane body ``dense_lane_source``, summed over
the lanes, too; ``stack_chains``/``unstack_chains`` exact against the
JAX layout; more than 32 rows raise."""

import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.ops import mlp_dense as jdense
from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, IIDNormalPrior, loss_functions, mlp
from eeyore_tpu_torch.ops import mlp_dense

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])


def iris30():
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    return ds.x[::5], ds.y[::5]  # 30 rows, all three classes


def models(name):
    """(port model, JAX model, x, y) of one case."""
    if name == "xor_mlp221":
        dims, loss, act, (x, y) = [2, 2, 1], "binary_classification", "default", (XOR_X, XOR_Y)
    elif name == "xor_mlp2321":
        dims, loss, act, (x, y) = [2, 3, 2, 1], "binary_classification", "default", (XOR_X,
                                                                                      XOR_Y)
    else:
        dims, loss, (x, y) = [4, 3, 3], "multiclass_classification", iris30()
        act = None
    port = MLP(loss=loss_functions[loss], dtype=torch.float32, device="cpu",
               hparams=mlp.Hyperparameters(
                   dims=dims, activations=act or [mlp.sigmoid, None]))
    ref = JMLP(loss=jloss_functions[loss], dtype=jnp.float32,
               hparams=jmlp.Hyperparameters(
                   dims=dims, activations=act or [jmlp.sigmoid, None]))
    if name == "xor_mlp2321":  # a prior with non-zero means and a temperature
        P = port.num_params
        port.prior = IIDNormalPrior(np.full(P, 0.25), np.full(P, 1.5), dtype=torch.float32,
                                    device="cpu")
        port.temperature = 0.7
        from eeyore_tpu.models import IIDNormalPrior as JPrior
        ref.prior = JPrior(jnp.full(P, 0.25, jnp.float32), jnp.full(P, 1.5, jnp.float32))
        ref.temperature = 0.7
    return port, ref, x, y


CASES = ["xor_mlp221", "xor_mlp2321", "iris30_mlp433_ce"]


def thetas(C, P, seed=0):
    return np.random.default_rng(seed).normal(size=(C, P)).astype(np.float32)


@pytest.mark.parametrize("with_grad", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_make_vg_dense_matches_jax(name, with_grad):
    port, ref, x, y = models(name)
    th = thetas(64, port.num_params)
    tiles = th.T.reshape(port.num_params, 8, 8)
    got = mlp_dense.make_vg_dense(port, x, y, with_grad=with_grad)(
        tuple(torch.as_tensor(t) for t in tiles))
    want = jdense.make_vg_dense(ref, x, y, with_grad=with_grad)([jnp.asarray(t) for t in tiles])
    if with_grad:
        (got, got_g), (want, want_g) = got, want
        assert len(got_g) == port.num_params
        np.testing.assert_allclose(np.stack([g.numpy() for g in got_g]),
                                   np.stack([np.asarray(g) for g in want_g]),
                                   rtol=2e-5, atol=2e-4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-4)


def _interpret(source, fn, th, r=None):
    """Evaluate the emitted C++ function ``fn`` ("v", "vg", "lane_v" or
    "lane_vg") on float32 arrays ``th`` (a list of P [C] arrays), with a lane
    body's rows ``r``, with numpy: (value, grads)."""
    body = source.split(f"float {fn}(")[1].split("\n}")[0].splitlines()[1:]
    f32 = np.float32
    env = {"th": th, "g": [None] * len(th), "np": np, "f32": f32, "r": r}

    def translate(expr):
        m = re.fullmatch(r"(\S+) >= 0\.0f \? (\S+) : (\S+)", expr)
        if m:
            return f"np.where({m.group(1)} >= 0, {m.group(2)}, {m.group(3)})"
        expr = re.sub(r"(0x[0-9a-f.]+p[+-]\d+)f", r"f32(float.fromhex('\1'))", expr)
        expr = re.sub(r"\b(\d+\.\d+)f\b", r"f32(\1)", expr)
        for c_name, np_name in (("expf", "np.exp"), ("log1pf", "np.log1p"), ("logf", "np.log"),
                                ("fabsf", "np.abs"), ("fmaxf", "np.maximum")):
            expr = re.sub(rf"\b{c_name}\(", f"{np_name}(", expr)
        return expr

    with np.errstate(over="ignore"):
        for line in body:
            line = line.strip().rstrip(";")
            if line.startswith("const float "):
                name, expr = line[len("const float "):].split(" = ", 1)
                env[name] = np.asarray(eval(translate(expr), env), dtype=f32)
            elif line.startswith("g["):
                target, expr = line.split(" = ", 1)
                env["g"][int(target[2:-1])] = np.asarray(eval(translate(expr), env), dtype=f32)
            else:
                assert line.startswith("return "), line
                return np.asarray(eval(translate(line[len("return "):]), env)), env["g"]


@pytest.mark.parametrize("name", CASES)
def test_dense_source_is_the_same_program(name):
    """The CUDA body that the dense kernels compile, read back with numpy,
    equals the plain ``make_vg_dense`` (both orders of operations are the
    one ``_program`` writes)."""
    port, _, x, y = models(name)
    th = thetas(256, port.num_params, seed=1)
    source = mlp_dense.dense_source(port, x, y)
    assert f"constexpr int kP = {port.num_params};" in source
    tiles = tuple(torch.as_tensor(th[:, p]) for p in range(port.num_params))
    val, grads = mlp_dense.make_vg_dense(port, x, y)(tiles)
    for fn in ("v", "vg"):
        got, got_g = _interpret(source, fn, [th[:, p] for p in range(port.num_params)])
        np.testing.assert_allclose(got, val.numpy(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(np.stack(got_g), np.stack([g.numpy() for g in grads]),
                               rtol=1e-6, atol=1e-5)


def test_dense_source_drops_zero_inputs_and_counts_its_work():
    """XOR's zero inputs leave no product with a weight of layer 0 (nvcc
    without fast math would keep 0 * w), and unit inputs are adds; the
    value-only body does a fraction of the gradient body's work."""
    port, _, x, y = models("xor_mlp221")
    source = mlp_dense.dense_source(port, x, y)
    layer0 = {f"th[{p}]" for p in range(4)}
    for line in source.splitlines():
        if " * " in line:
            assert not any(w in line.split(" * ") for w in layer0), line
    ops_vg, sfu_vg = mlp_dense.dense_work(port, x, y, with_grad=True)
    ops_v, sfu_v = mlp_dense.dense_work(port, x, y, with_grad=False)
    # per row: 2 hidden sigmoids (2 exps and 2 reciprocals) and the softplus
    # (exp, log1p); the gradient adds the output sigmoid's reciprocal
    assert sfu_v == 4 * (4 + 2) and sfu_vg == sfu_v + 4
    assert 0 < ops_v < ops_vg


def _constant(source, name):
    """The initializer of the emitted ``__constant__`` array ``name`` as a
    float32 numpy array."""
    text = re.search(rf"__constant__ float {name}(?:\[\d+\])+ = (.*);", source).group(1)
    text = re.sub(r"\(?(-?)(0x[0-9a-f.]+p[+-]\d+)f\)?", r"\1float.fromhex('\2')", text)
    return np.asarray(eval(text.replace("{", "[").replace("}", "]")), dtype=np.float32)


@pytest.mark.parametrize("name,rows,lanes", [
    ("xor_mlp221", 4, 4), ("xor_mlp221", 4, 2), ("xor_mlp2321", 4, 4), ("xor_mlp2321", 3, 2),
    ("iris30_mlp433_ce", 30, 4), ("iris30_mlp433_ce", 30, 8)])
def test_dense_lane_source_sums_to_the_program(name, rows, lanes):
    """The lane body that the dense MH, MALA and ladder kernels compile, read
    back with numpy: each lane's partial log-likelihood and gradient on its
    rows l, l + lanes, ... (the inputs, labels and masks of its generated
    constants; a lane without a row in a slot masks it), summed over the
    lanes and with the prior on every coordinate, equals ``make_vg_dense``
    (1e-5 relative: the sums run in another order)."""
    port, _, x, y = models(name)
    x, y = x[:rows], y[:rows]
    P = port.num_params
    th = thetas(64, P, seed=3)
    source = mlp_dense.dense_lane_source(port, x, y, lanes)
    slots, full = mlp_dense.lane_rows(rows, lanes)
    assert f"constexpr int kSlots = {slots};" in source
    masked = re.findall(r"r\.m\[(\d+)\]", source)  # the slots some lane lacks
    assert sorted({int(q) for q in masked}) == list(range(full, slots))
    lane_x, lane_y, lane_m = (_constant(source, k) for k in ("kLaneX", "kLaneY", "kLaneM"))
    for lane in range(lanes):
        for q in range(slots):
            row = lane + q * lanes
            assert lane_m[lane, q] == (1.0 if row < rows else 0.0)
            if row < rows:
                np.testing.assert_array_equal(lane_x[lane, q], np.float32(x[row]))
                np.testing.assert_array_equal(lane_y[lane, q], np.float32(y[row]))
    ll, g_ll = 0.0, np.zeros((P, th.shape[0]))
    cols = [th[:, p] for p in range(P)]
    for lane in range(lanes):
        r = SimpleNamespace(x=lane_x[lane], y=lane_y[lane], m=lane_m[lane])
        v_lane, _ = _interpret(source, "lane_v", cols, r)
        vg_lane, g_lane = _interpret(source, "lane_vg", cols, r)
        np.testing.assert_allclose(v_lane, vg_lane, rtol=1e-6, atol=1e-6)
        ll, g_ll = ll + vg_lane.astype(np.float64), g_ll + np.stack(g_lane)
    _, _, loc, ivar, prior_const, temperature = mlp_dense.prepare_dense(port, x, y)
    loc, ivar = _constant(source, "kLoc"), _constant(source, "kIvar")
    diff = th.T.astype(np.float64) - loc[:, None]
    val = temperature * (ll + np.sum(-0.5 * diff * diff * ivar[:, None], axis=0) + prior_const)
    grad = temperature * (g_ll - diff * ivar[:, None])
    want_val, want_grads = mlp_dense.make_vg_dense(port, x, y)(
        tuple(torch.as_tensor(c) for c in cols))
    np.testing.assert_allclose(val, want_val.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(grad, np.stack([g.numpy() for g in want_grads]), rtol=1e-5,
                               atol=1e-4)


def test_stack_and_unstack_are_exact_and_match_jax():
    th = thetas(64, 9, seed=2)
    dense = mlp_dense.stack_chains(torch.as_tensor(th))
    assert dense.shape == (72, 8)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense.stack_chains(th)))
    back = mlp_dense.unstack_chains(dense, 9)
    np.testing.assert_array_equal(back.numpy(), th)
    lead = torch.stack([dense, 2 * dense])  # [..., P*8, lanes]
    np.testing.assert_array_equal(mlp_dense.unstack_chains(lead, 9)[1].numpy(), 2 * th)
    with pytest.raises(ValueError, match="multiple of 8"):
        mlp_dense.stack_chains(torch.zeros(12, 9))


def test_more_than_32_rows_raise():
    port, _, _, _ = models("iris30_mlp433_ce")
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    assert mlp_dense.MAX_DENSE_ROWS == 32
    for build in (lambda: mlp_dense.make_vg_dense(port, ds.x[:33], ds.y[:33]),
                  lambda: mlp_dense.dense_source(port, ds.x, ds.y),
                  lambda: mlp_dense.prepare_dense(port, ds.x[:40], ds.y[:40])):
        with pytest.raises(ValueError, match="MAX_DENSE_ROWS"):
            build()
    mlp_dense.make_vg_dense(port, ds.x[:32], ds.y[:32])
