"""Port parity, fused log-posterior: the port's plain ``make_vg`` (the plain
version of the CUDA kernel ``fused_mlp_vg``) against ``jax.value_and_grad``
in float64, and against the JAX Pallas kernel in interpret mode in float32
with the tolerances of ``tests/test_ops.py::compare``. The CUDA kernel itself
is held against ``make_vg`` on the card by ``chip_smoke.py``."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.models import IIDNormalPrior as JIIDNormalPrior
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.ops.fused_mlp import make_fused_log_target_vg as jax_fused_vg
from eeyore_tpu_torch import convert
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops import fused_mlp
from eeyore_tpu_torch.ops.fused_mlp import FusedMLPModel, make_fused_log_target_vg
from eeyore_tpu_torch.ops.mlp_math import extract_arch, make_vg, prepare_data

RNG = np.random.default_rng(99)
F64_TOL = dict(rtol=1e-10, atol=1e-10)
XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])


def models(dims, loss, bias=None, dtype=64):
    """The same MLP in both packages (float64 or float32)."""
    ce = loss == "multiclass_classification"
    jacts = [jmlp.sigmoid] * (len(dims) - 2) + [None if ce else jmlp.sigmoid]
    tacts = [mlp.sigmoid] * (len(dims) - 2) + [None if ce else mlp.sigmoid]
    jm = JMLP(loss=jloss_functions[loss],
              hparams=jmlp.Hyperparameters(dims=dims, bias=bias, activations=jacts),
              dtype=jnp.float64 if dtype == 64 else jnp.float32)
    tm = MLP(loss=loss_functions[loss],
             hparams=mlp.Hyperparameters(dims=dims, bias=bias, activations=tacts),
             dtype=torch.float64 if dtype == 64 else torch.float32, device="cpu")
    return jm, tm


def set_prior(jm, tm, loc, scale, temperature):
    jm.prior = JIIDNormalPrior(loc, scale)
    jm.temperature = temperature
    tm.prior = convert.prior_from_numpy(loc, scale, device="cpu", dtype=tm.dtype)
    tm.temperature = temperature


def case(name, dtype=64):
    """(jax model, port model, x, y, atol) of each architecture of test_ops."""
    rng = np.random.default_rng({"xor": 1, "deep": 2, "iris": 3, "prior": 4}[name])
    if name == "xor":
        jm, tm = models([2, 2, 1], "binary_classification", dtype=dtype)
        return jm, tm, XOR_X, XOR_Y, 1e-4
    if name == "deep":
        jm, tm = models([3, 4, 2, 1], "binary_classification", bias=[False, True, False],
                        dtype=dtype)
        x = rng.normal(size=(10, 3))
        return jm, tm, x, rng.integers(0, 2, size=(10, 1)).astype(np.float64), 1e-4
    if name == "iris":
        jm, tm = models([4, 3, 3], "multiclass_classification", dtype=dtype)
        x = rng.normal(size=(150, 4))
        return jm, tm, x, np.eye(3)[rng.integers(0, 3, 150)], 3e-4
    jm, tm = models([2, 2, 1], "binary_classification", dtype=dtype)
    set_prior(jm, tm, np.full(9, 0.5), np.full(9, 2.0), 0.3)
    return jm, tm, XOR_X[[0, 3]], XOR_Y[[0, 3]], 1e-4


CASES = ["xor", "deep", "iris", "prior"]


def jax_reference(jm, x, y, thetas):
    return jax.vmap(lambda t: jax.value_and_grad(jm.log_target)(
        t, jnp.asarray(x), jnp.asarray(y)))(jnp.asarray(thetas))


def plain_vg(tm, x, y, dtype, with_grad=True, split=False):
    arrays = prepare_data(tm, x, y, dtype=dtype)
    vg = make_vg(tm, *arrays, with_grad=with_grad, split=split)
    tensors = [torch.as_tensor(a) for a in arrays[:5]]
    return lambda theta_t: vg(theta_t, *tensors)


@pytest.mark.parametrize("name", CASES)
def test_make_vg_f64_matches_value_and_grad(name):
    jm, tm, x, y, _ = case(name)
    thetas = RNG.normal(size=(16, tm.num_params))
    jv, jg = jax_reference(jm, x, y, thetas)
    val, grad = plain_vg(tm, x, y, np.float64)(torch.as_tensor(thetas.T))
    assert val.shape == (1, 16) and grad.shape == (tm.num_params, 16)
    np.testing.assert_allclose(val.numpy()[0], np.asarray(jv), **F64_TOL)
    np.testing.assert_allclose(grad.numpy().T, np.asarray(jg), **F64_TOL)


@pytest.mark.parametrize("name", CASES)
def test_make_vg_split_and_value_only_f64(name):
    """split=True gives the untempered (ll, lp, gll, glp); with_grad=False
    gives the value alone (or (ll, lp) with split)."""
    jm, tm, x, y, _ = case(name)
    thetas = RNG.normal(size=(8, tm.num_params))
    theta_t = torch.as_tensor(thetas.T)
    cold = jm.with_temperature(None)
    jll, jgll = jax.vmap(lambda t: jax.value_and_grad(cold.log_lik)(
        t, jnp.asarray(x), jnp.asarray(y)))(jnp.asarray(thetas))
    jlp, jglp = jax.vmap(jax.value_and_grad(cold.log_prior))(jnp.asarray(thetas))

    ll, lp, gll, glp = plain_vg(tm, x, y, np.float64, split=True)(theta_t)
    for got, want in ((ll[0], jll), (lp[0], jlp), (gll.T, jgll), (glp.T, jglp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)

    ll_only, lp_only = plain_vg(tm, x, y, np.float64, with_grad=False, split=True)(theta_t)
    np.testing.assert_allclose(ll_only.numpy()[0], np.asarray(jll), **F64_TOL)
    np.testing.assert_allclose(lp_only.numpy()[0], np.asarray(jlp), **F64_TOL)

    jv, _ = jax_reference(jm, x, y, thetas)
    val = plain_vg(tm, x, y, np.float64, with_grad=False)(theta_t)
    np.testing.assert_allclose(val.numpy()[0], np.asarray(jv), **F64_TOL)


@pytest.mark.parametrize("name", CASES)
def test_fused_vg_f32_matches_pallas_interpret(name):
    """The port's fused function on the CPU (the plain version, in float32)
    against the Pallas kernel in interpret mode."""
    jm, tm, x, y, atol = case(name, dtype=32)
    n_chains = 128
    thetas = RNG.normal(size=(n_chains, tm.num_params)).astype(np.float32)
    jfn = jax_fused_vg(jm, x, y, chain_block=n_chains, interpret=True)
    jv, jg = jfn(jnp.asarray(thetas))
    before = fused_mlp.launch_counts["fused_mlp_vg"]
    vals, grads = make_fused_log_target_vg(tm, x, y, device="cpu")(torch.as_tensor(thetas))
    assert fused_mlp.launch_counts["fused_mlp_vg"] == before  # CPU: no kernel launch
    assert vals.dtype == torch.float32 and vals.shape == (n_chains,)
    assert grads.shape == (n_chains, tm.num_params)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=2e-5, atol=atol)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jg), rtol=2e-5, atol=atol)


@pytest.mark.parametrize("n_chains", [1, 37, 130])
def test_any_chain_count(n_chains):
    """No chain_block divisibility rule: any C gives each chain the value of
    the C = 1 call on that chain."""
    _, tm, x, y, _ = case("deep", dtype=32)
    fn = make_fused_log_target_vg(tm, x, y, device="cpu")
    thetas = torch.as_tensor(RNG.normal(size=(n_chains, tm.num_params)).astype(np.float32))
    vals, grads = fn(thetas)
    for c in (0, n_chains - 1):
        v1, g1 = fn(thetas[c:c + 1])
        torch.testing.assert_close(vals[c:c + 1], v1, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(grads[c:c + 1], g1, rtol=1e-6, atol=1e-5)


def test_rejects_unsupported_loss():
    model = MLP(loss=lambda p, y: torch.sum(p), hparams=mlp.Hyperparameters(dims=[2, 2, 1]),
                dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError):
        make_fused_log_target_vg(model, np.zeros((2, 2)), np.zeros((2, 1)), device="cpu")


@pytest.mark.parametrize("acts,loss", [
    ([mlp.sigmoid, None], "binary_classification"),
    ([mlp.sigmoid, mlp.sigmoid], "multiclass_classification"),
    ([None, mlp.sigmoid], "binary_classification"),
])
def test_rejects_unsupported_activations(acts, loss):
    model = MLP(loss=loss_functions[loss],
                hparams=mlp.Hyperparameters(dims=[2, 2, 1], activations=acts),
                dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError):
        extract_arch(model)


def test_extract_arch_matches_jax():
    jm, tm, _, _, _ = case("deep")
    from eeyore_tpu.ops.mlp_math import extract_arch as jax_extract_arch

    assert extract_arch(tm) == jax_extract_arch(jm)


def test_prepare_data_matches_jax():
    from eeyore_tpu.ops.mlp_math import prepare_data as jax_prepare_data

    jm, tm, x, y, _ = case("prior", dtype=32)
    ours = prepare_data(tm, x, y)
    theirs = jax_prepare_data(jm, x, y)
    for a, b in zip(ours[:5], theirs[:5]):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ours[5:] == pytest.approx(theirs[5:], rel=1e-12)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors only; it never computes
    on the CPU. The fixed data arrays are checked once, when they become the
    kernel's arguments (``fused_data``), the chains on every launch."""
    p, c, n = 9, 4, 8
    tensors = [torch.zeros(s) for s in ((c, p), (n, 2), (n, 1), (n, 1), (p, 1), (p, 1))]
    before = fused_mlp.launch_counts["fused_mlp_vg"]
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_mlp_vg(None, tensors[0], None, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_data(*tensors[1:], 0.0, 1.0)
    assert fused_mlp.launch_counts["fused_mlp_vg"] == before


def test_thetas_on_another_device_raise():
    _, tm, x, y, _ = case("xor", dtype=32)
    fn = make_fused_log_target_vg(tm, x, y, device="cpu")
    with pytest.raises(ValueError, match="built for"):
        fn(torch.empty(3, tm.num_params, device="meta"))


def test_fused_model_wrapper_and_defaults():
    _, tm, x, y, _ = case("xor", dtype=32)
    wrapped = FusedMLPModel(tm, x, y, device="cpu")
    thetas = torch.as_tensor(RNG.normal(size=(3, tm.num_params)).astype(np.float32))
    v, g = wrapped.batch_upto_grad_log_target(thetas)
    ref_v, ref_g = tm.upto_grad_log_target(thetas.double(), torch.as_tensor(x),
                                           torch.as_tensor(y))
    np.testing.assert_allclose(v.numpy(), ref_v.numpy(), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), ref_g.numpy(), rtol=2e-5, atol=1e-4)
    for fn in (make_fused_log_target_vg, FusedMLPModel.__init__, MLP.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
