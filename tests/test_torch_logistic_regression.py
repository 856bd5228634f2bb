"""Port, Bayesian logistic regression (``models/logistic_regression.py``)
against the JAX package's: the forward pass, log-likelihood, log-target and
gradient in float64 on random data and on the Swiss banknotes, raw and
standardised; ``extract_arch``'s one-layer branch; the dispatch decisions of
HMC, fixed-budget NUTS, MH, MALA, even/odd ladders and SMC on 200 and 10
rows, equal to JAX's at platform "tpu"; ``Gibbs`` refusing LR; and the plain
kernel path, ``sample_chains(backend="resident", platform="cuda")`` on CPU
tensors, against JAX's scanned MH and MALA over 8 seeds; and tuned HMC in
float32, whose scanned path strands chains in both packages while the plain
kernel path strands none."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.models import LogisticRegression as JLogisticRegression
from eeyore_tpu.models import logistic_regression as jlr
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.ops.mlp_math import extract_arch as jextract_arch
from eeyore_tpu.samplers import HMC as JHMC
from eeyore_tpu.samplers import MALA as JMALA
from eeyore_tpu.samplers import NUTS as JNUTS
from eeyore_tpu.samplers import Gibbs as JGibbs
from eeyore_tpu.samplers import MetropolisHastings as JMH
from eeyore_tpu.samplers import PowerPosteriorSampler as JPowerPosteriorSampler
from eeyore_tpu.samplers import SMCSampler as JSMCSampler
from eeyore_tpu.samplers import sample_chains as jsample_chains
from eeyore_tpu.samplers.dispatch import resolve_backend as jresolve_backend
from eeyore_tpu.samplers.dispatch import resolve_smc as jresolve_smc
from eeyore_tpu.samplers.dispatch import resolve_tempering as jresolve_tempering
from eeyore_tpu.tuners.dual_averaging import HMCDATuner as JHMCDATuner
from eeyore_tpu_torch import convert
from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import LogisticRegression, logistic_regression, loss_functions
from eeyore_tpu_torch.ops.mlp_math import extract_arch
from eeyore_tpu_torch.samplers import (
    HMC,
    MALA,
    NUTS,
    Gibbs,
    MetropolisHastings,
    PowerPosteriorSampler,
    SMCSampler,
    sample_chains,
)
from eeyore_tpu_torch.samplers.dispatch import resolve_backend, resolve_smc, resolve_tempering
from eeyore_tpu_torch.tuners import HMCDATuner

RNG = np.random.default_rng(15)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread is many times faster than a pool
    on a shared machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def banknotes(standardise=True):
    ds = XYDataset.from_eeyore("banknotes")
    x = ds.x
    if standardise:
        x = (x - x.mean(axis=0)) / x.std(axis=0)
    return x, ds.y


def lr_pair(input_size=6, output_size=1, loss="binary_classification", activation="default",
            bias=True, dtype=torch.float64):
    """(port model on the CPU, JAX model) of one architecture."""
    jact = activation if activation != "default" else "default"
    model = LogisticRegression(loss_functions[loss], device="cpu", dtype=dtype,
                               hparams=logistic_regression.Hyperparameters(
                                   input_size, output_size, bias=bias, activation=activation))
    jmodel = JLogisticRegression(jloss_functions[loss], hparams=jlr.Hyperparameters(
        input_size, output_size, bias=bias, activation=jact))
    return model, jmodel


def value_and_grad(model, theta, x, y):
    t = torch.as_tensor(theta)
    return model.upto_grad_log_target(t, torch.as_tensor(x), torch.as_tensor(y))


def jax_value_and_grad(jmodel, theta, x, y):
    val, grad = jmodel.upto_grad_log_target(jnp.asarray(theta), jnp.asarray(x), jnp.asarray(y))
    return np.asarray(val), np.asarray(grad)


def test_forward_and_log_lik_as_the_jax_test():
    """tests/test_models.py's logistic-regression case: LR(3, 1) on 6 rows
    against the closed form, and the port against JAX."""
    model, jmodel = lr_pair(3, 1)
    assert model.num_params == jmodel.num_params == 4
    x = RNG.normal(size=(6, 3))
    y = RNG.integers(0, 2, size=(6, 1)).astype(float)
    theta = RNG.normal(size=4)
    preds = 1.0 / (1.0 + np.exp(-(x @ theta[:3] + theta[3])))[:, None]
    expected = np.sum(np.log(preds) * y + np.log(1 - preds) * (1 - y))
    got = model.log_lik(torch.as_tensor(theta), torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(float(got), expected, rtol=1e-12)
    np.testing.assert_allclose(
        float(got), float(jmodel.log_lik(jnp.asarray(theta), jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-12)
    fwd = model.forward(torch.as_tensor(theta), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(fwd, preds, rtol=1e-12)


@pytest.mark.parametrize("standardise", [True, False])
def test_log_target_and_gradient_equal_jax_on_banknotes(standardise):
    """f64, 1e-10: single thetas and a batch of 5 (each its own gradient).
    On the raw features (about 130-215) the thetas are small, so no row
    saturates."""
    x, y = banknotes(standardise)
    model, jmodel = lr_pair()
    scale = 1.0 if standardise else 0.004
    thetas = scale * RNG.normal(size=(5, 7))
    vals, grads = value_and_grad(model, thetas, x, y)
    assert vals.shape == (5,) and grads.shape == (5, 7)
    for c in range(5):
        jval, jgrad = jax_value_and_grad(jmodel, thetas[c], x, y)
        assert np.isfinite(jval)
        np.testing.assert_allclose(vals[c].item(), jval, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(grads[c].numpy(), jgrad, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(
            model.forward(torch.as_tensor(thetas[c]), torch.as_tensor(x)).numpy(),
            np.asarray(jmodel.forward(jnp.asarray(thetas[c]), jnp.asarray(x))), rtol=1e-10,
            atol=1e-12)


def test_saturated_rows_finite_on_the_right_side_and_minus_inf_on_the_wrong():
    """On the raw features a large theta (a cut of the diagonal at 140.45)
    saturates every row's sigmoid in f32: with the labels that cut gives,
    every row is saturated on its own label's side, and the log-likelihood
    stays finite and the gradient free of NaN; one flipped label is a row
    saturated on the wrong side, and gives -inf, in both packages."""
    x, _ = banknotes(standardise=False)
    model, jmodel = lr_pair(dtype=torch.float32)
    theta = np.zeros(7, dtype=np.float32)
    theta[5] = -1000.0
    theta[6] = 1000.0 * 140.45
    z = x @ theta[:6] + theta[6]
    y = (z > 0).astype(np.float64)[:, None]
    assert 0 < y.sum() < 200 and np.min(np.abs(z)) > 17
    xt, yt = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    val, grad = model.upto_grad_log_target(torch.as_tensor(theta), xt, yt)
    jval, jgrad = jax_value_and_grad(jmodel, theta, x.astype(np.float32), y.astype(np.float32))
    assert np.isfinite(val.item()) and np.isfinite(jval)
    np.testing.assert_allclose(val.item(), jval, rtol=1e-5)
    assert torch.isfinite(grad).all() and np.all(np.isfinite(jgrad))
    y_wrong = y.copy()
    y_wrong[0] = 1.0 - y_wrong[0]
    wrong = model.log_lik(torch.as_tensor(theta), xt, torch.as_tensor(y_wrong, dtype=torch.float32))
    jwrong = jmodel.log_lik(jnp.asarray(theta), jnp.asarray(x, dtype=jnp.float32),
                            jnp.asarray(y_wrong, dtype=jnp.float32))
    assert wrong.item() == float(jwrong) == -np.inf


def test_forward_runs_matmuls_at_full_f32():
    """The matmul runs at "highest" whatever the process default, and the
    caller's setting comes back."""
    model, _ = lr_pair(dtype=torch.float32)
    seen = []
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        real = torch.matmul
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch, "matmul", lambda *a: seen.append(
                torch.get_float32_matmul_precision()) or real(*a))
            model.forward(torch.zeros(7), torch.zeros((3, 6)))
        assert seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(previous)


@pytest.mark.parametrize("arch", [
    dict(input_size=6, output_size=1),
    dict(input_size=6, output_size=1, bias=False),
    dict(input_size=4, output_size=3, loss="multiclass_classification", activation=None),
])
def test_extract_arch_lr_branch_equals_jax(arch):
    model, jmodel = lr_pair(**arch, dtype=torch.float32)
    dims, bias, loss_kind, offsets = extract_arch(model)
    assert (dims, bias, loss_kind, offsets) == tuple(jextract_arch(jmodel))
    assert dims == [arch["input_size"], arch["output_size"]] and bias == [arch.get("bias", True)]


def test_extract_arch_refuses_what_jax_refuses():
    for arch in (dict(activation=None), dict(loss="multiclass_classification")):
        model, jmodel = lr_pair(**arch, dtype=torch.float32)
        with pytest.raises(ValueError) as raised:
            extract_arch(model)
        with pytest.raises(ValueError) as jraised:
            jextract_arch(jmodel)
        assert str(raised.value) == str(jraised.value)


def test_gibbs_refuses_logistic_regression_as_jax_does():
    model, jmodel = lr_pair(dtype=torch.float32)
    with pytest.raises(ValueError, match="parameter blocks"):
        Gibbs(model, scales=0.1)
    with pytest.raises(ValueError, match="parameter blocks"):
        JGibbs(jmodel, scales=0.1)


def test_thetas_from_numpy_takes_jax_lr_thetas():
    _, jmodel = lr_pair()
    model, _ = lr_pair(dtype=torch.float32)
    draws = np.asarray(jax.vmap(jmodel.sample_prior)(jax.random.split(jax.random.PRNGKey(0), 4)))
    t = convert.thetas_from_numpy(draws, model, device="cpu")
    assert t.shape == (4, 7) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), draws.astype(np.float32))
    with pytest.raises(ValueError, match="7"):
        convert.thetas_from_numpy(draws[:, :6], model, device="cpu")


# ---- dispatch: the same decisions as JAX's at platform "tpu" ----

def problem(rows):
    """(port LR, JAX LR, x, y): standardised banknotes (200 rows), its first
    10 rows, or multiclass LR(4, 3) on iris (150 rows)."""
    if rows == "iris":
        ds = XYDataset.from_eeyore("iris", yonehot=True)
        model, jmodel = lr_pair(4, 3, "multiclass_classification", None, dtype=torch.float32)
        return model, jmodel, ds.x, ds.y
    x, y = banknotes()
    model, jmodel = lr_pair(dtype=torch.float32)
    return model, jmodel, x[:rows], y[:rows]


def kernel_pair(name, model, jmodel):
    return {
        "hmc": lambda: (HMC(model, step=0.02, num_steps=8), JHMC(jmodel, step=0.02, num_steps=8)),
        "hmc_tuned": lambda: (
            HMC(model, tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64),
            JHMC(jmodel, tuner=JHMCDATuner(l=0.15, e0=0.02), max_num_steps=64)),
        "nuts": lambda: (NUTS(model, step=0.02, max_depth=3, fixed_budget=True),
                         JNUTS(jmodel, step=0.02, max_depth=3, fixed_budget=True)),
        "mh": lambda: (MetropolisHastings(model, scale=0.1), JMH(jmodel, scale=0.1)),
        "mala": lambda: (MALA(model, step=0.01), JMALA(jmodel, step=0.01)),
    }[name]()


def summary(plan):
    return None if plan is None else (plan.backend, plan.maker.__name__, plan.chain_block)


@pytest.mark.parametrize("rows", [200, 10, "iris"])
@pytest.mark.parametrize("name", ["hmc", "hmc_tuned", "nuts", "mh", "mala"])
def test_dispatch_decides_as_jax(rows, name):
    """Maker, chain block and (where it runs generic) the reason equal
    JAX's, over chain counts and backends; where JAX raises, the port raises
    the same message."""
    model, jmodel, x, y = problem(rows)
    kernel, jkernel = kernel_pair(name, model, jmodel)
    for C in (1000, 1024, 4096, 16384, 32768):
        for backend in ("auto", "resident", "dense"):
            try:
                jplan, jreason = jresolve_backend(jkernel, (x, y), C, 2048, 1024,
                                                  platform="tpu", backend=backend)
            except ValueError as err:
                with pytest.raises(ValueError) as raised:
                    resolve_backend(kernel, (x, y), C, 2048, 1024, platform="cuda",
                                    backend=backend)
                assert str(raised.value) == str(err), (C, backend)
                continue
            plan, reason = resolve_backend(kernel, (x, y), C, 2048, 1024, platform="cuda",
                                           backend=backend)
            assert summary(plan) == summary(jplan), (C, backend, reason, jreason)
            if jplan is None:
                assert reason == jreason, (C, backend)
    if rows == 200:  # the chip's main paths
        plan, reason = resolve_backend(kernel, (x, y), 16384, 2048, 1024, platform="cuda")
        assert plan is not None and plan.backend == "resident", reason


@pytest.mark.parametrize("rows", [200, 10, "iris"])
@pytest.mark.parametrize("sampler,kw", [("MALA", {"step": 0.01}), ("MetropolisHastings",
                                                                     {"scale": 0.1})])
def test_tempering_dispatch_decides_as_jax(rows, sampler, kw):
    model, jmodel, x, y = problem(rows)
    for L in (8, 16):
        pp = PowerPosteriorSampler(model, num_chains=L, sampler=sampler, sampler_kwargs=kw,
                                   swap_scheme="even_odd")
        jpp = JPowerPosteriorSampler(jmodel, num_chains=L, sampler=sampler, sampler_kwargs=kw,
                                     swap_scheme="even_odd")
        for backend in ("auto", "resident"):
            jplan, jreason = jresolve_tempering(jpp, (x, y), 2048, 1024, platform="tpu",
                                                backend=backend)
            plan, reason = resolve_tempering(pp, (x, y), 2048, 1024, platform="cuda",
                                             backend=backend)
            assert summary(plan) == summary(jplan), (L, backend, reason, jreason)


@pytest.mark.parametrize("rows", [200, 10, "iris"])
@pytest.mark.parametrize("mutation", ["MALA", "MH"])
def test_smc_dispatch_decides_as_jax(rows, mutation):
    model, jmodel, x, y = problem(rows)
    for N in (1000, 1024, 4096, 16384):
        cb, jreason = jresolve_smc(JSMCSampler(jmodel, N, mutation=mutation), (x, y),
                                   platform="tpu")
        plan, reason = resolve_smc(SMCSampler(model, N, mutation=mutation), (x, y),
                                   platform="cuda")
        assert (None if plan is None else plan.chain_block) == cb, (N, reason, jreason)
        if plan is not None:
            assert plan.maker.__name__ == "make_resident_smc"


# ---- the plain kernel path against JAX's scanned MH and MALA ----

def pooled(samples):
    means = np.asarray(samples, np.float64).mean(axis=1)
    return means.mean(axis=0), means.std(axis=0, ddof=1) / np.sqrt(means.shape[0])


@pytest.mark.parametrize("name", ["mh", "mala"])
def test_kernel_path_agrees_with_jax_over_seeds(name):
    """8 seeds: the plain staged kernel through ``sample_chains`` on the
    200 standardised rows and JAX's scanned sampler, from prior draws:
    pooled means within 5 pooled standard errors, acceptance within 0.05."""
    x, y = banknotes()
    model, jmodel = lr_pair(dtype=torch.float32)
    kernel, jkernel = kernel_pair(name, model, jmodel)
    C, iters, burnin = 128, 300, 150
    jdata = (jnp.asarray(x, dtype=jnp.float32), jnp.asarray(y, dtype=jnp.float32))
    port_rows, jax_rows, port_acc, jax_acc = [], [], [], []
    for seed in range(8):
        th = torch.as_tensor(0.5 * np.random.default_rng(100 + seed).normal(size=(C, 7)),
                             dtype=torch.float32)
        got = sample_chains(kernel, torch.Generator().manual_seed(seed), th, (x, y), iters,
                            burnin, return_arrays=True, backend="resident", platform="cuda")
        port_rows.append(got["sample"].numpy())
        port_acc.append(got["accepted"].double().mean().item())
        rec = jsample_chains(jkernel, jax.random.PRNGKey(seed),
                             jnp.asarray(0.5 * np.random.default_rng(200 + seed).normal(
                                 size=(C, 7)), dtype=jnp.float32),
                             jdata, iters, burnin, return_arrays=True, backend="scan",
                             record_keys=("sample", "accepted"))
        jax_rows.append(np.asarray(rec["sample"]))
        jax_acc.append(float(np.mean(rec["accepted"])))
    m1, s1 = pooled(np.concatenate(port_rows))
    m2, s2 = pooled(np.concatenate(jax_rows))
    z = np.abs(m1 - m2) / np.sqrt(s1 ** 2 + s2 ** 2)
    assert z.max() < 5.0, z
    assert abs(np.mean(port_acc) - np.mean(jax_acc)) < 0.05, (port_acc, jax_acc)


# ---- tuned HMC in float32: the generic paths strand chains, the kernel path none ----

TUNED_C, TUNED_ITERS, TUNED_BURNIN = 256, 200, 100


def tuned_start(seed):
    return 0.1 * np.random.default_rng(seed).normal(size=(TUNED_C, 7))


def stranded_and_nan_steps(accepted, step):
    """(share of chains that accepted nothing after burn-in, share whose
    final step is NaN, whether every such chain is one with a NaN step)."""
    stranded = np.asarray(accepted, np.float64).sum(axis=1) == 0
    nan_step = np.isnan(np.asarray(step, np.float64))
    return stranded.mean(), nan_step.mean(), bool(np.array_equal(stranded, nan_step))


@pytest.mark.parametrize("seed", [0, 1])
def test_scanned_tuned_hmc_strands_lr_chains_in_both_packages(seed):
    """Why the tuned LR kernel run on the card is held against the generic
    untuned HMC, not the generic tuned one: on the 200 standardised rows in
    float32, both packages' scanned tuned HMC (``HMCDATuner(l=0.15,
    e0=0.02)``, ``max_num_steps=64``) leave a tenth to a half of the chains
    accepting nothing after burn-in, exactly those whose dual-averaged step
    turned NaN, and the two shares agree within 0.12."""
    x, y = banknotes()
    model, _ = lr_pair(dtype=torch.float32)
    jmodel = JLogisticRegression(jloss_functions["binary_classification"], dtype=jnp.float32,
                                 hparams=jlr.Hyperparameters(6, 1))
    kernel, jkernel = kernel_pair("hmc_tuned", model, jmodel)
    th = tuned_start(seed)
    got, state = sample_chains(kernel, torch.Generator().manual_seed(seed),
                               torch.as_tensor(th, dtype=torch.float32), (x, y), TUNED_ITERS,
                               TUNED_BURNIN, record_keys=("sample", "accepted"),
                               return_state=True, return_arrays=True, backend="scan")
    rec, jstate = jsample_chains(jkernel, jax.random.PRNGKey(seed),
                                 jnp.asarray(th, dtype=jnp.float32),
                                 (jnp.asarray(x, dtype=jnp.float32),
                                  jnp.asarray(y, dtype=jnp.float32)), TUNED_ITERS, TUNED_BURNIN,
                                 record_keys=("sample", "accepted"), return_state=True,
                                 return_arrays=True, backend="scan")
    port = stranded_and_nan_steps(got["accepted"].numpy(), state.step.numpy())
    ref = stranded_and_nan_steps(rec["accepted"], jstate.step)
    for share, nan_share, same in (port, ref):
        assert 0.1 < share < 0.5 and same, (port, ref)
    assert abs(port[0] - ref[0]) < 0.12, (port, ref)


def test_tuned_hmc_kernel_path_strands_no_lr_chain():
    """The same runs on the plain staged HMC kernel, which evaluates the BCE
    in z-space: every chain accepts and every step stays finite."""
    x, y = banknotes()
    model, jmodel = lr_pair(dtype=torch.float32)
    for seed in (0, 1):
        kernel, _ = kernel_pair("hmc_tuned", model, jmodel)
        got, state = sample_chains(kernel, torch.Generator().manual_seed(seed),
                                   torch.as_tensor(tuned_start(seed), dtype=torch.float32),
                                   (x, y), TUNED_ITERS, TUNED_BURNIN, return_state=True,
                                   return_arrays=True, backend="resident", platform="cuda")
        share, nan_share, _ = stranded_and_nan_steps(got["accepted"].numpy(),
                                                     state.step.numpy())
        assert share == 0.0 and nan_share == 0.0, (seed, share, nan_share)
