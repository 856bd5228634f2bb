"""Port parity, generic HMC: the port's batched ``HMC`` against the JAX
package's one-chain ``HMC`` vmapped over chains, in float64 on the same numpy
inputs and JAX's own random draws. Leapfrog, one transition, the initial-step
heuristic and the per-chain tuner are held to 1e-10; ``sample_chains`` on
the generic path statistically."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.samplers import HMC as JHMC
from eeyore_tpu.samplers import sample_chains as jsample_chains
from eeyore_tpu.tuners.dual_averaging import HMCDATuner as JHMCDATuner
from eeyore_tpu_torch import convert
from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.samplers import HMC, HMCState, sample_chain, sample_chains
from eeyore_tpu_torch.tuners import DualAveragingState, HMCDATuner

F64_TOL = dict(rtol=1e-10, atol=1e-10)
XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])


def problem(name):
    """(jax model, port model, x, y) in float64."""
    if name == "xor":
        dims, loss, acts, x, y = [2, 2, 1], "binary_classification", None, XOR_X, XOR_Y
    else:
        ds = XYDataset.from_eeyore("iris", yonehot=True)
        dims, loss, x, y = [4, 3, 3], "multiclass_classification", ds.x, ds.y
    jacts = None if name == "xor" else [jmlp.sigmoid, None]
    tacts = "default" if name == "xor" else [mlp.sigmoid, None]
    jm = JMLP(loss=jloss_functions[loss], dtype=jnp.float64,
              hparams=jmlp.Hyperparameters(dims=dims, activations=jacts or "default"))
    tm = MLP(loss=loss_functions[loss], dtype=torch.float64, device="cpu",
             hparams=mlp.Hyperparameters(dims=dims, activations=tacts))
    return jm, tm, x, y


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("name", ["xor", "iris"])
def test_leapfrog_matches_jax_given_momenta(name):
    """Per-chain steps and trajectory lengths (0 to 7): the batch runs to
    the longest and freezes the others, as JAX's per-chain while loop ends."""
    jm, tm, x, y = problem(name)
    C = 16
    rng = np.random.default_rng(5)
    thetas = 0.5 * rng.normal(size=(C, tm.num_params))
    momenta = rng.normal(size=(C, tm.num_params))
    steps = rng.uniform(0.01, 0.08, size=C)
    num_steps = np.arange(C) % 8
    jhmc, thmc = JHMC(jm), HMC(tm)
    jx, jy = jnp.asarray(x), jnp.asarray(y)

    def one(th, mom, st, n):
        _, grad = jhmc.upto_grad_log_target(th, jx, jy)
        return jhmc.leapfrog(th, mom, grad, st, n, jx, jy)

    jout = jax.vmap(one)(jnp.asarray(thetas), jnp.asarray(momenta), jnp.asarray(steps),
                         jnp.asarray(num_steps, dtype=jnp.int32))
    _, grads = thmc.upto_grad_log_target(t(thetas), t(x), t(y))
    tout = thmc.leapfrog(t(thetas), t(momenta), grads, t(steps), t(num_steps), t(x), t(y))
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)
    assert float(tout[2][0]) == 0.0  # num_steps 0: target 0, as in JAX


@pytest.mark.parametrize("iteration", [0, 3, 4, 9])
def test_step_fn_matches_jax_given_draws(iteration):
    """One tuned transition of 64 XOR chains with JAX's momenta and
    uniforms, at, just before and after the burn-in hand-off (burn-in 5)."""
    jm, tm, x, y = problem("xor")
    C, burnin = 64, 5
    rng = np.random.default_rng(3)
    thetas = rng.normal(size=(C, tm.num_params))
    jhmc = JHMC(jm, step=0.4, tuner=JHMCDATuner(l=1.0, e0=0.4), max_num_steps=64)
    thmc = HMC(tm, step=0.4, tuner=HMCDATuner(l=1.0, e0=0.4), max_num_steps=64)
    jhmc.num_burnin_iters = thmc.num_burnin_iters = burnin
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    js = jax.vmap(lambda th: jhmc.init(th, jx, jy))(jnp.asarray(thetas))
    # per-chain steps and trajectory lengths, and one untuned move apart
    steps = rng.uniform(0.3, 3.0, size=C)
    js = js._replace(step=jnp.asarray(steps), num_steps=jhmc.tuner.num_steps(jnp.asarray(steps)))
    warm_keys = jax.random.split(jax.random.PRNGKey(100), C)
    js, _ = jax.vmap(lambda k, s: jhmc.step_fn(k, s, jx, jy, jnp.asarray(50)))(warm_keys, js)
    keys = jax.random.split(jax.random.PRNGKey(iteration), C)

    def draws(key):
        key_mom, key_acc = jax.random.split(key)
        return (jax.random.normal(key_mom, (tm.num_params,), dtype=jnp.float64),
                jax.random.uniform(key_acc, dtype=jnp.float64))

    momenta, uniforms = jax.vmap(draws)(keys)
    jnew, jinfo = jax.vmap(lambda k, s: jhmc.step_fn(k, s, jx, jy, jnp.asarray(iteration)))(
        keys, js)
    ts = convert.hmc_state_from_numpy(js, tm, device="cpu", dtype=torch.float64)
    tnew, tinfo = thmc.step_fn(ts, t(x), t(y), iteration, momenta=t(momenta),
                               uniforms=t(uniforms))
    np.testing.assert_array_equal(tinfo["accepted"].numpy(), np.asarray(jinfo["accepted"]))
    assert 0 < int(tinfo["accepted"].sum()) < C
    for f in HMCState._fields:
        if f == "tuner":
            for g in DualAveragingState._fields:
                np.testing.assert_allclose(getattr(tnew.tuner, g).numpy(),
                                           np.asarray(getattr(jnew.tuner, g)), **F64_TOL)
        else:
            np.testing.assert_allclose(getattr(tnew, f).numpy(), np.asarray(getattr(jnew, f)),
                                       **F64_TOL)
    assert tnew.num_steps.dtype == torch.int32


def test_find_initial_step_matches_jax_with_its_momenta():
    jm, tm, x, y = problem("iris")
    C = 12
    thetas = np.random.default_rng(8).normal(size=(C, tm.num_params)) * np.linspace(0.05, 2, C)[:, None]
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    jhmc, thmc = JHMC(jm, tuner=JHMCDATuner(l=0.5)), HMC(tm, tuner=HMCDATuner(l=0.5))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    jsteps = jax.vmap(lambda k, th: jhmc.find_initial_step(k, th, jx, jy))(keys, jnp.asarray(thetas))
    momenta = jax.vmap(lambda k: jax.random.normal(k, (tm.num_params,), dtype=jnp.float64))(keys)
    tsteps = thmc.find_initial_step(t(thetas), t(x), t(y), momenta=t(momenta))
    np.testing.assert_allclose(tsteps.numpy(), np.asarray(jsteps), rtol=1e-12)
    assert len(set(tsteps.tolist())) > 1  # the chains stopped at different doublings


def test_per_chain_tuner_trace_matches_jax():
    """30 updates of 8 chains' tuners over fixed per-chain rates, with the
    hand-off at the last burn-in iteration, against JAX's vmapped tune."""
    C, burnin = 8, 30
    rates = np.random.default_rng(9).uniform(0, 1, size=(burnin, C))
    e0 = np.linspace(0.05, 0.4, C)
    jt, tt = JHMCDATuner(l=0.6, eub=0.3), HMCDATuner(l=0.6, eub=0.3)
    js = jax.vmap(lambda e: jt.init(e, dtype=jnp.float64))(jnp.asarray(e0))
    ts = tt.init(t(e0), dtype=torch.float64, device="cpu")
    for idx in range(burnin):
        return_e = idx != burnin - 1
        js, je, jn = jax.vmap(lambda s, r: jt.tune(s, r, jnp.asarray(idx), return_e))(
            js, jnp.asarray(rates[idx]))
        ts, te, tn = tt.tune(ts, t(rates[idx]), idx, return_e)
        for f in DualAveragingState._fields:
            np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                       **F64_TOL)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), **F64_TOL)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("e0", [0.02, None])
def test_init_matches_jax(e0):
    jm, tm, x, y = problem("iris")
    C = 6
    thetas = 0.3 * np.random.default_rng(2).normal(size=(C, tm.num_params))
    jhmc = JHMC(jm, tuner=JHMCDATuner(l=0.15, e0=e0))
    thmc = HMC(tm, tuner=HMCDATuner(l=0.15, e0=e0))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    keys = jax.random.split(jax.random.PRNGKey(1), C)
    js = jax.vmap(lambda k, th: jhmc.init(th, jx, jy, key=k))(keys, jnp.asarray(thetas))
    if e0 is None:  # the heuristic with JAX's momenta stands in for init's draws
        momenta = jax.vmap(lambda k: jax.random.normal(k, (tm.num_params,), jnp.float64))(keys)
        steps = thmc.find_initial_step(t(thetas), t(x), t(y), momenta=t(momenta))
        np.testing.assert_allclose(steps.numpy(), np.asarray(js.step), rtol=1e-12)
        return
    ts = thmc.init(t(thetas), t(x), t(y))
    for f in ("sample", "target_val", "grad_val", "step", "num_steps"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), **F64_TOL)
    for f in DualAveragingState._fields:
        np.testing.assert_allclose(getattr(ts.tuner, f).numpy(), np.asarray(getattr(js.tuner, f)),
                                   **F64_TOL)
    assert int(ts.num_steps[0]) == 8  # round(0.15 / 0.02), half to even


def test_init_without_e0_runs_the_heuristic_per_chain():
    _, tm, x, y = problem("xor")
    thmc = HMC(tm, tuner=HMCDATuner(l=0.5, eub=0.25))
    state = thmc.init(torch.zeros(4, tm.num_params, dtype=torch.float64), t(x), t(y),
                      generator=torch.Generator().manual_seed(0))
    assert state.step.shape == (4,) and bool((state.step <= 0.25).all())
    torch.testing.assert_close(state.num_steps, thmc.tuner.num_steps(state.step))


def test_config_checks():
    _, tm, _, _ = problem("xor")
    with pytest.raises(ValueError, match="trajectory length"):
        HMC(tm, tuner=HMCDATuner(e0=0.1))
    with pytest.raises(ValueError, match="l_rounding"):
        HMC(tm, l_rounding="nearest")
    assert HMC(tm, l_rounding="stochastic").l_rounding == "stochastic"
    assert not HMC(tm).explicit_max_num_steps and HMC(tm).max_num_steps == 1024
    assert HMC(tm, max_num_steps=64).explicit_max_num_steps


def test_max_num_steps_caps_the_trajectory():
    _, tm, x, y = problem("xor")
    thmc = HMC(tm, step=0.001, tuner=HMCDATuner(l=1.0, e0=0.001), max_num_steps=7)
    state = thmc.init(torch.zeros(3, tm.num_params, dtype=torch.float64), t(x), t(y))
    assert int(state.num_steps[0]) == 1000
    calls = []
    vg = thmc.upto_grad_log_target
    thmc.upto_grad_log_target = lambda *a: calls.append(1) or vg(*a)
    thmc.step_fn(state, t(x), t(y), 10, generator=torch.Generator().manual_seed(0))
    assert len(calls) == 7


def test_sample_chains_generic_matches_jax_statistically():
    """The generic path against JAX's scanned path on XOR (step 0.1, 5
    leapfrog steps, 128 chains, 300 iterations, 100 burn-in): pooled means
    within 5 pooled standard errors, acceptance within 0.05."""
    jm, tm, x, y = problem("xor")
    C = 128
    theta0s = 0.1 * np.random.default_rng(0).normal(size=(C, tm.num_params))
    jchains = jsample_chains(JHMC(jm, step=0.1, num_steps=5), jax.random.PRNGKey(0),
                             jnp.asarray(theta0s), (jnp.asarray(x), jnp.asarray(y)), 300, 100,
                             backend="scan", return_arrays=True)
    tchains = sample_chains(HMC(tm, step=0.1, num_steps=5), torch.Generator().manual_seed(0),
                            t(theta0s), (x, y), 300, 100, backend="scan")
    assert tchains.get_samples().shape == (C, 200, tm.num_params)
    assert set(tchains.keys()) == set(HMC.state_keys)
    jm_, tm_ = np.asarray(jchains["sample"]).mean(1), tchains.get_samples().mean(1).numpy()
    se = np.sqrt(jm_.var(0, ddof=1) / C + tm_.var(0, ddof=1) / C)
    assert np.all(np.abs(jm_.mean(0) - tm_.mean(0)) <= 5 * se)
    assert abs(np.asarray(jchains["accepted"]).mean() - tchains.acceptance_summary()) < 0.05


def test_sample_chains_records_thinned_states_and_returns_state():
    _, tm, x, y = problem("xor")
    kernel = HMC(tm, step=0.1, num_steps=3)
    theta0s = torch.zeros(4, tm.num_params, dtype=torch.float64)
    gen = torch.Generator().manual_seed(3)
    arrays, state = sample_chains(kernel, gen, theta0s, (x, y), 12, 4,
                                  record_keys=("sample", "accepted"), record_thin=2,
                                  return_arrays=True, return_state=True, backend="scan")
    assert arrays["sample"].shape == (4, 4, tm.num_params)
    torch.testing.assert_close(arrays["sample"][:, -1], state.sample)  # last of each block
    with pytest.raises(ValueError, match="record_thin"):
        sample_chains(kernel, gen, theta0s, (x, y), 12, 4, record_thin=3)
    chain = sample_chain(kernel, gen, theta0s[0], (x, y), 10, 2, backend="scan")
    assert chain.get_samples().shape == (8, tm.num_params) and len(chain) == 8
