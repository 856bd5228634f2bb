"""Port, random-walk samplers on the generic path: the proposal kernels
(``kernels/proposal_kernels.py``), ``samplers/mh.py`` and
``samplers/mala.py`` against the JAX package. Densities, the MALA drift and
its Normal log-density equal JAX's in float64 (1e-10); the accept algebra
with given draws equals the formula written out with the JAX kernels'
densities; ``sample_chains(..., backend="scan")`` agrees with JAX's
``sample_chains`` on XOR within 5 pooled standard errors of the posterior
means and of the acceptance rate; and ``convert`` carries JAX states over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu import kernels as jkernels
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.samplers import MALA as JMALA
from eeyore_tpu.samplers import MetropolisHastings as JMH
from eeyore_tpu.samplers import sample_chains as jsample_chains
from eeyore_tpu_torch import convert
from eeyore_tpu_torch.kernels import DEMCKernel, MultivariateNormalKernel, NormalKernel
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.samplers import MALA, MetropolisHastings, sample_chains

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])
F64 = dict(rtol=1e-10, atol=1e-10)


def xor_models(dims=(2, 2, 1)):
    port = MLP(loss=loss_functions["binary_classification"], dtype=torch.float64, device="cpu",
               hparams=mlp.Hyperparameters(dims=list(dims)))
    ref = JMLP(loss=jloss_functions["binary_classification"], dtype=jnp.float64,
               hparams=jmlp.Hyperparameters(dims=list(dims)))
    return port, ref


def rng_arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) for s in shapes]


def per_chain(fn, *arrays):
    """A JAX function of single vectors, on [C, P] numpy arrays."""
    return np.array(jax.vmap(fn)(*[jnp.asarray(a) for a in arrays]))


@pytest.mark.parametrize("scale", [0.3, "vector"])
def test_normal_kernel_log_prob_matches_jax(scale):
    x, loc = rng_arrays((16, 5), (16, 5))
    if scale == "vector":
        scale = np.linspace(0.2, 2.0, 5)
    got = NormalKernel(scale).log_prob(torch.as_tensor(x), torch.as_tensor(loc))
    want = per_chain(jkernels.NormalKernel(scale).log_prob, x, loc)
    assert got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), want, **F64)


def test_multivariate_normal_kernel_log_prob_matches_jax():
    x, loc, a = rng_arrays((16, 4), (16, 4), (4, 4), seed=1)
    tril = np.tril(a) + np.diag(np.full(4, 2.5))
    got = MultivariateNormalKernel(tril).log_prob(torch.as_tensor(x), torch.as_tensor(loc))
    want = per_chain(jkernels.MultivariateNormalKernel(tril).log_prob, x, loc)
    np.testing.assert_allclose(got.numpy(), want, **F64)


def test_demc_kernel_mean_and_log_prob_match_jax():
    x, theta, a, b = rng_arrays((16, 6), (16, 6), (16, 6), (16, 6), seed=2)
    port, ref = DEMCKernel(c=0.3, scale=0.05), jkernels.DEMCKernel(c=0.3, scale=0.05)
    t = [torch.as_tensor(v) for v in (x, theta, a, b)]
    np.testing.assert_allclose(port.mean(*t[1:]).numpy(),
                               per_chain(ref.mean, theta, a, b), **F64)
    np.testing.assert_allclose(port.log_prob(*t).numpy(),
                               per_chain(ref.log_prob, x, theta, a, b), **F64)


def test_kernel_samples_have_the_right_moments():
    gen = torch.Generator().manual_seed(0)
    loc = torch.full((20000, 3), 1.5, dtype=torch.float64)
    draws = NormalKernel(0.5).sample(gen, loc)
    assert abs(draws.mean().item() - 1.5) < 0.01 and abs(draws.std().item() - 0.5) < 0.01
    tril = torch.tensor([[1.0, 0.0, 0.0], [0.5, 1.0, 0.0], [0.0, 0.3, 0.2]], dtype=torch.float64)
    draws = MultivariateNormalKernel(tril).sample(gen, torch.zeros(20000, 3, dtype=torch.float64))
    np.testing.assert_allclose(torch.cov(draws.T).numpy(), (tril @ tril.T).numpy(), atol=0.03)
    a, b = torch.ones(20000, 3), torch.zeros(20000, 3)
    draws = DEMCKernel(c=0.5, scale=1e-3).sample(gen, torch.zeros(20000, 3), a, b)
    assert abs(draws.mean().item() - 0.5) < 1e-3


def test_mala_mean_and_normal_log_prob_match_jax():
    port_model, ref_model = xor_models()
    sample, grad, x = rng_arrays((8, 9), (8, 9), (8, 9), seed=3)
    port, ref = MALA(port_model, step=0.07), JMALA(ref_model, step=0.07)
    np.testing.assert_allclose(
        port.kernel_mean(torch.as_tensor(sample), torch.as_tensor(grad)).numpy(),
        per_chain(ref.kernel_mean, sample, grad), **F64)
    np.testing.assert_allclose(
        port._normal_log_prob(torch.as_tensor(x), torch.as_tensor(sample)).numpy(),
        per_chain(ref._normal_log_prob, x, sample), **F64)


def test_mh_and_mala_accept_algebra_with_given_draws():
    """One step of each with given proposals (MH), noise (MALA) and
    uniforms: the log rate written out with the JAX kernels' densities, and
    log(u) < log_rate."""
    port_model, ref_model = xor_models()
    x, y = torch.as_tensor(XOR_X), torch.as_tensor(XOR_Y)
    th, noise = (torch.as_tensor(a) for a in rng_arrays((64, 9), (64, 9), seed=4))
    th = 0.5 * th
    u = torch.as_tensor(np.random.default_rng(5).uniform(size=64))
    # asymmetric MH with a vector scale: the two densities cancel exactly
    scale = np.linspace(0.1, 0.5, 9)
    mh = MetropolisHastings(port_model, symmetric=False, kernel=NormalKernel(scale))
    prop = th + torch.as_tensor(scale) * noise
    state, info = mh.step_fn(mh.init(th, x, y), x, y, proposal=prop, uniforms=u)
    jk = jkernels.NormalKernel(scale)
    log_rate = (port_model.log_target(prop, x, y) - port_model.log_target(th, x, y)
                - torch.as_tensor(per_chain(jk.log_prob, prop.numpy(), th.numpy()))
                + torch.as_tensor(per_chain(jk.log_prob, th.numpy(), prop.numpy())))
    accept = torch.log(u) < log_rate
    assert 0 < int(accept.sum()) < 64
    assert torch.equal(info["accepted"].bool(), accept)
    torch.testing.assert_close(state.sample, torch.where(accept[:, None], prop, th))

    mala = MALA(port_model, step=0.3)
    s0 = mala.init(th, x, y)
    state, info = mala.step_fn(s0, x, y, noise=noise, uniforms=u)
    ref = JMALA(ref_model, step=0.3)
    fwd = per_chain(ref.kernel_mean, th.numpy(), s0.grad_val.numpy())
    prop = torch.as_tensor(fwd) + np.sqrt(0.3) * noise
    val, grad = port_model.upto_grad_log_target(prop, x, y)
    rev = per_chain(ref.kernel_mean, prop.numpy(), grad.numpy())
    log_rate = (val - s0.target_val
                - torch.as_tensor(per_chain(ref._normal_log_prob, prop.numpy(), fwd))
                + torch.as_tensor(per_chain(ref._normal_log_prob, th.numpy(), rev)))
    accept = torch.log(u) < log_rate
    assert 0 < int(accept.sum()) < 64
    assert torch.equal(info["accepted"].bool(), accept)
    torch.testing.assert_close(state.grad_val, torch.where(accept[:, None], grad, s0.grad_val))


@pytest.mark.parametrize("sampler", ["mh", "mala"])
def test_scan_runs_match_jax_statistically(sampler):
    """XOR, 256 chains, 600 iterations, 200 burn-in, from the same theta0s:
    the port's generic path against JAX's scanned path."""
    dims = (2, 2, 1) if sampler == "mh" else (2, 3, 2, 1)
    port_model, ref_model = xor_models(dims)
    C = 256
    th = 0.1 * np.random.default_rng(6).normal(size=(C, port_model.num_params))
    if sampler == "mh":
        port, ref = MetropolisHastings(port_model, scale=0.3), JMH(ref_model, scale=0.3)
    else:
        port, ref = MALA(port_model, step=0.5), JMALA(ref_model, step=0.5)
    keys = ("sample", "accepted")
    got = sample_chains(port, torch.Generator().manual_seed(7), torch.as_tensor(th),
                        (XOR_X, XOR_Y), 600, 200, record_keys=keys, return_arrays=True,
                        backend="scan")
    want = jsample_chains(ref, jax.random.PRNGKey(1), jnp.asarray(th),
                          (jnp.asarray(XOR_X), jnp.asarray(XOR_Y)), 600, 200, backend="scan",
                          return_arrays=True, record_keys=keys)
    assert got["sample"].shape == (C, 400, port_model.num_params)
    for k in keys:
        a = got[k].double().mean(1).reshape(C, -1).numpy()   # chain means
        b = np.asarray(want[k], dtype=np.float64).mean(1).reshape(C, -1)
        se = np.sqrt(a.var(0, ddof=1) / C + b.var(0, ddof=1) / C)
        assert np.all(np.abs(a.mean(0) - b.mean(0)) <= 5 * se), k
    assert 0.1 < got["accepted"].double().mean().item() < 0.95


def test_convert_walk_states_from_jax():
    port_model, ref_model = xor_models()
    th = 0.3 * np.random.default_rng(8).normal(size=(16, 9))
    x, y = jnp.asarray(XOR_X), jnp.asarray(XOR_Y)
    tx, ty = torch.as_tensor(XOR_X), torch.as_tensor(XOR_Y)
    jstate = jax.vmap(JMH(ref_model).init, in_axes=(0, None, None))(jnp.asarray(th), x, y)
    state = convert.mh_state_from_numpy(jstate, port_model, device="cpu", dtype=torch.float64)
    want = MetropolisHastings(port_model).init(torch.as_tensor(th), tx, ty)
    torch.testing.assert_close(state.target_val, want.target_val, **F64)
    assert state.accepted.dtype == torch.int32 and state.sample.shape == (16, 9)
    jstate = jax.vmap(JMALA(ref_model).init, in_axes=(0, None, None))(jnp.asarray(th), x, y)
    state = convert.mala_state_from_numpy(jstate, port_model, device="cpu", dtype=torch.float64)
    want = MALA(port_model).init(torch.as_tensor(th), tx, ty)
    torch.testing.assert_close(state.grad_val, want.grad_val, **F64)
    np.testing.assert_array_equal(convert.to_numpy(state).sample, th)
