"""Port parity, fused HMC: the port's dual-averaging tuner and ``FusedHMC``
against the JAX package. The tuner is held in float64 to 1e-10; the leapfrog
and the accept step, given the same momenta and uniforms, in float32 to
1e-5; sampled runs statistically, with the bounds of ``tests/test_ops.py``.
The JAX side runs its Pallas kernel in interpret mode."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.ops.fused_hmc import FusedHMC as JFusedHMC
from eeyore_tpu.tuners.dual_averaging import HMCDATuner as JHMCDATuner
from eeyore_tpu_torch import convert
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops.fused_hmc import FusedHMC, FusedHMCState
from eeyore_tpu_torch.tuners import DualAveragingState, HMCDATuner

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]], dtype=np.float32)
XOR_Y = np.array([[0.], [1.], [1.], [0.]], dtype=np.float32)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def xor_models():
    jm = JMLP(loss=jloss_functions["binary_classification"],
              hparams=jmlp.Hyperparameters(dims=[2, 2, 1]), dtype=jnp.float32)
    tm = MLP(loss=loss_functions["binary_classification"],
             hparams=mlp.Hyperparameters(dims=[2, 2, 1]), dtype=torch.float32, device="cpu")
    return jm, tm, XOR_X, XOR_Y


def iris_models():
    from eeyore_tpu_torch.datasets import XYDataset

    ds = XYDataset.from_eeyore("iris", yonehot=True)
    jm = JMLP(loss=jloss_functions["multiclass_classification"],
              hparams=jmlp.Hyperparameters(dims=[4, 3, 3], activations=[jmlp.sigmoid, None]),
              dtype=jnp.float32)
    tm = MLP(loss=loss_functions["multiclass_classification"],
             hparams=mlp.Hyperparameters(dims=[4, 3, 3], activations=[mlp.sigmoid, None]),
             dtype=torch.float32, device="cpu")
    return jm, tm, ds.x.astype(np.float32), ds.y.astype(np.float32)


MODELS = {"xor": xor_models, "iris": iris_models}


@pytest.mark.parametrize("eub", [None, 0.3])
def test_tuner_matches_jax_f64(eub):
    """50 dual-averaging updates over a fixed sequence of rates, with the
    burn-in hand-off (the averaged step) at the last one: every state field,
    the returned step and num_steps equal JAX's."""
    rates = np.random.default_rng(7).uniform(0.0, 1.0, size=50)
    burnin = len(rates)
    jt = JHMCDATuner(l=0.6, e0=0.2, eub=eub)
    tt = HMCDATuner(l=0.6, e0=0.2, eub=eub)
    js = jt.init(0.2, dtype=jnp.float64)
    ts = tt.init(0.2, dtype=torch.float64, device="cpu")
    assert int(tt.num_steps(ts.loge.exp())) == int(jt.num_steps(jnp.exp(js.loge))) == 3
    for idx, rate in enumerate(rates):
        return_e = idx != burnin - 1
        js, je, jn = jt.tune(js, jnp.asarray(rate), jnp.asarray(idx), return_e)
        ts, te, tn = tt.tune(ts, torch.tensor(rate, dtype=torch.float64), idx, return_e)
        for f in DualAveragingState._fields:
            np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-10, atol=1e-10)
        assert int(tn) == int(jn) and tn.dtype == torch.int32
    # the last update returned the averaged step, not the instantaneous one
    np.testing.assert_allclose(te.numpy(), np.exp(ts.logbare.numpy()), rtol=1e-12)


def test_tuner_without_trajectory_length_pins_one_step():
    tt = HMCDATuner()
    assert int(tt.num_steps(torch.tensor(0.01))) == 1
    assert int(HMCDATuner(l=1e-6).num_steps(torch.tensor(0.5))) == 1


def jax_state(jhmc, theta0s):
    return jhmc.init(jnp.asarray(theta0s))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_matches_jax(name):
    jm, tm, x, y = MODELS[name]()
    C = 16
    theta0s = 0.3 * np.random.default_rng(1).normal(size=(C, tm.num_params)).astype(np.float32)
    tuner_args = dict(l=0.15, e0=0.02)
    jhmc = JFusedHMC(jm, x, y, step=0.02, tuner=JHMCDATuner(**tuner_args), chain_block=C,
                     interpret=True)
    thmc = FusedHMC(tm, x, y, step=0.02, tuner=HMCDATuner(**tuner_args), device="cpu")
    js = jax_state(jhmc, theta0s)
    ts = thmc.init(convert.thetas_from_numpy(theta0s, tm, device="cpu"))
    for f in ("thetas", "target_vals", "grads", "step"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), **F32_TOL)
    assert int(ts.num_steps) == int(js.num_steps) == 8


@pytest.mark.parametrize("name", sorted(MODELS))
def test_leapfrog_matches_jax_given_momenta(name):
    jm, tm, x, y = MODELS[name]()
    C = 32
    rng = np.random.default_rng(11)
    theta0s = (0.5 * rng.normal(size=(C, tm.num_params))).astype(np.float32)
    momenta = rng.normal(size=(C, tm.num_params)).astype(np.float32)
    jhmc = JFusedHMC(jm, x, y, step=0.05, num_steps=6, chain_block=C, interpret=True)
    thmc = FusedHMC(tm, x, y, step=0.05, num_steps=6, device="cpu")
    js = jax_state(jhmc, theta0s)
    ts = convert.fused_hmc_state_from_numpy(js, tm, device="cpu")
    jout = jhmc.leapfrog(js.thetas, jnp.asarray(momenta), js.grads, js.step, js.num_steps)
    tout = thmc.leapfrog(ts.thetas, torch.as_tensor(momenta), ts.grads, ts.step,
                         int(ts.num_steps))
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("iteration", [0, 3, 4, 5])
def test_step_fn_matches_jax_given_draws(iteration):
    """One transition with JAX's own momenta and uniforms: leapfrog, the MH
    accept, and the tuner at, just before and after the burn-in hand-off
    (burn-in 5). On XOR, where |H| ~ 10: the rate is exp of a difference of
    two f32 energies, so its error grows with |H| (about 4e-5 on iris, where
    |H| ~ 200; iris' leapfrog is held to 1e-5 above)."""
    jm, tm, x, y = xor_models()
    C, burnin = 64, 5
    rng = np.random.default_rng(3)
    theta0s = rng.normal(size=(C, tm.num_params)).astype(np.float32)
    tuner_args = dict(l=1.0, e0=0.4)  # a long step, so that some chains reject
    jhmc = JFusedHMC(jm, x, y, step=0.4, tuner=JHMCDATuner(**tuner_args), chain_block=C,
                     interpret=True, max_num_steps=64)
    thmc = FusedHMC(tm, x, y, step=0.4, tuner=HMCDATuner(**tuner_args), device="cpu",
                    max_num_steps=64)
    js = jax_state(jhmc, theta0s)
    key = jax.random.PRNGKey(iteration)
    key_mom, key_acc = jax.random.split(key)
    momenta = jax.random.normal(key_mom, js.thetas.shape, dtype=jnp.float32)
    uniforms = jax.random.uniform(key_acc, (C,), dtype=jnp.float32)

    jnew, jinfo = jhmc.step_fn(key, js, jnp.asarray(iteration), burnin)
    ts = convert.fused_hmc_state_from_numpy(js, tm, device="cpu")
    tnew, tinfo = thmc.step_fn(ts, iteration, burnin, momenta=torch.tensor(np.asarray(momenta)),
                               uniforms=torch.tensor(np.asarray(uniforms)))

    np.testing.assert_array_equal(tinfo["accepted"].numpy(), np.asarray(jinfo["accepted"]))
    assert 0 < tinfo["accepted"].sum() < C
    for k in ("sample", "target_val", "rate"):
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]), **F32_TOL)
    jnp_state = convert.to_numpy(tnew)
    for f in ("thetas", "target_vals", "grads", "step"):
        np.testing.assert_allclose(getattr(jnp_state, f), np.asarray(getattr(jnew, f)), **F32_TOL)
    assert int(tnew.num_steps) == int(jnew.num_steps)
    for f in DualAveragingState._fields:
        np.testing.assert_allclose(getattr(jnp_state.tuner, f), np.asarray(getattr(jnew.tuner, f)),
                                   **F32_TOL)


def test_unfused_path_matches_fused_on_cpu():
    """use_fused_kernel=False (batched autograd of model.log_target) runs the
    same leapfrog as the fused function."""
    _, tm, x, y = iris_models()
    rng = np.random.default_rng(4)
    theta0s = torch.as_tensor((0.3 * rng.normal(size=(8, tm.num_params))).astype(np.float32))
    momenta = torch.as_tensor(rng.normal(size=(8, tm.num_params)).astype(np.float32))
    fused = FusedHMC(tm, x, y, step=0.02, num_steps=4, device="cpu")
    plain = FusedHMC(tm, x, y, step=0.02, num_steps=4, device="cpu", use_fused_kernel=False)
    sf, sp = fused.init(theta0s), plain.init(theta0s)
    for got, want in zip(plain.leapfrog(sp.thetas, momenta, sp.grads, sp.step, 4),
                         fused.leapfrog(sf.thetas, momenta, sf.grads, sf.step, 4)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=3e-4)


def test_run_records_and_counts():
    _, tm, x, y = xor_models()
    C = 8
    hmc = FusedHMC(tm, x, y, step=0.1, num_steps=3, device="cpu")
    theta0s = torch.zeros(C, tm.num_params)
    state, rec = hmc.run(0, theta0s, 12, 4, record_keys=("sample", "accepted", "rate"))
    assert rec["sample"].shape == (8, C, tm.num_params)
    assert rec["accepted"].shape == (8, C) and rec["accepted"].dtype == torch.int32
    assert rec["rate"].shape == (8, C)
    torch.testing.assert_close(rec["sample"][-1], state.thetas)
    _, rec2 = hmc.run(0, theta0s, 12, 4, record_keys=("sample", "accepted", "rate"))
    torch.testing.assert_close(rec2["sample"], rec["sample"])  # a seed fixes the run
    with pytest.raises(ValueError, match="record keys"):
        hmc.run(0, theta0s, 2, 0, record_keys=("nope",))
    assert inspect.signature(FusedHMC.__init__).parameters["device"].default == "cuda"


def test_num_steps_capped_at_max():
    _, tm, x, y = xor_models()
    calls = []
    hmc = FusedHMC(tm, x, y, step=0.01, tuner=HMCDATuner(l=1.0, e0=0.01), max_num_steps=7,
                   device="cpu")
    vg = hmc.vg
    hmc.vg = lambda th: calls.append(1) or vg(th)
    state = hmc.init(torch.zeros(4, tm.num_params))
    calls.clear()
    assert int(state.num_steps) == 100
    hmc.step_fn(state, 10, 0, generator=torch.Generator().manual_seed(0))
    assert len(calls) == 7


def test_convert_roundtrip():
    jm, tm, x, y = xor_models()
    C = 8
    theta0s = np.random.default_rng(2).normal(size=(C, tm.num_params)).astype(np.float32)
    jhmc = JFusedHMC(jm, x, y, step=0.2, tuner=JHMCDATuner(l=0.6, e0=0.2), chain_block=C,
                     interpret=True)
    js = jax_state(jhmc, theta0s)
    ts = convert.fused_hmc_state_from_numpy(js, tm, device="cpu")
    assert isinstance(ts, FusedHMCState) and ts.num_steps.dtype == torch.int32
    back = convert.to_numpy(ts)
    np.testing.assert_array_equal(back.thetas, np.asarray(js.thetas))
    np.testing.assert_array_equal(back.tuner.loge, np.asarray(js.tuner.loge))
    assert int(back.num_steps) == int(js.num_steps)
    with pytest.raises(ValueError, match="parameters"):
        convert.thetas_from_numpy(np.zeros((2, tm.num_params + 1)), tm, device="cpu")
    assert convert.temperature_from_numpy(np.float32(0.5)) == 0.5
    assert convert.temperature_from_numpy(None) is None


def test_posterior_mean_matches_jax_statistically():
    """Port vs JAX FusedHMC on XOR, same start and settings as
    tests/test_ops.py::TestFusedHMC: pooled posterior means agree within that
    test's atol."""
    jm, tm, x, y = xor_models()
    C = 64
    theta0s = 0.1 * np.asarray(jax.random.normal(jax.random.PRNGKey(0), (C, tm.num_params),
                                                 dtype=jnp.float32))
    jhmc = JFusedHMC(jm, x, y, step=0.1, num_steps=5, chain_block=C, interpret=True)
    _, jrec = jhmc.run(jax.random.PRNGKey(0), jnp.asarray(theta0s), 600, 200)
    thmc = FusedHMC(tm, x, y, step=0.1, num_steps=5, device="cpu")
    _, trec = thmc.run(0, torch.as_tensor(theta0s), 600, 200)
    jax_mean = np.asarray(jrec["sample"]).reshape(-1, tm.num_params).mean(0)
    port_mean = trec["sample"].reshape(-1, tm.num_params).mean(0).numpy()
    assert np.all(np.isfinite(port_mean))
    np.testing.assert_allclose(port_mean, jax_mean, atol=0.35)
    jacc = np.asarray(jrec["accepted"]).mean()
    tacc = trec["accepted"].float().mean().item()
    assert 0.5 < tacc <= 1.0
    assert abs(tacc - jacc) < 0.1


def test_population_tuner_acceptance_matches_jax():
    """Population dual averaging pulls acceptance toward d = 0.65 in both
    packages (tests/test_ops.py::TestFusedHMC::test_population_tuner)."""
    jm, tm, x, y = xor_models()
    C = 32
    key = jax.random.PRNGKey(1)
    theta0s = 0.1 * np.asarray(jax.random.normal(key, (C, tm.num_params), dtype=jnp.float32))
    jhmc = JFusedHMC(jm, x, y, step=0.2, tuner=JHMCDATuner(l=0.6, e0=0.2), chain_block=C,
                     interpret=True)
    _, jrec = jhmc.run(key, jnp.asarray(theta0s), 500, 300)
    thmc = FusedHMC(tm, x, y, step=0.2, tuner=HMCDATuner(l=0.6, e0=0.2), device="cpu")
    _, trec = thmc.run(1, torch.as_tensor(theta0s), 500, 300)
    jacc = np.asarray(jrec["accepted"]).mean()
    tacc = trec["accepted"].float().mean().item()
    assert abs(tacc - 0.65) < 0.15
    assert abs(tacc - jacc) < 0.1
