"""Port, power-posterior tempering on the generic path:
``samplers/power_posterior.py`` and ``samplers/population.py`` against the
JAX package. The temperature ladder and the categorical swap probabilities
equal JAX's (1e-12); in float64, with JAX's own draws given (the normals,
proposals and uniforms its keys produce), ``init``, one batched within step
of MALA and MH at every temperature, the even/odd swap round of both
parities and the serial categorical sweep equal JAX's (1e-10); an all-equal
ladder swaps every valid pair; G ladders in one state equal G separate
ladders; ``run(backend="scan")`` on XOR agrees with JAX's scanned ladder
within 5 pooled standard errors of the cold rung's posterior means over
independent ladders."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu import kernels as jkernels
from eeyore_tpu.datasets import XYDataset as JXYDataset
from eeyore_tpu.datasets import as_schedule as jas_schedule
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.samplers import PowerPosteriorSampler as JPP
from eeyore_tpu.samplers import categorical_swap_probs as jcategorical_swap_probs
from eeyore_tpu.samplers import default_temperatures as jdefault_temperatures
from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.samplers import (
    PopulationKernel,
    PowerPosteriorSampler,
    categorical_swap_probs,
    default_temperatures,
    sample_population,
)

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])
F64 = dict(rtol=1e-10, atol=1e-10)


def problem(name):
    """(port model, JAX model, x, y) in float64."""
    if name == "xor":
        port = MLP(loss=loss_functions["binary_classification"], dtype=torch.float64,
                   device="cpu", hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
        ref = JMLP(loss=jloss_functions["binary_classification"], dtype=jnp.float64,
                   hparams=jmlp.Hyperparameters(dims=[2, 2, 1]))
        return port, ref, XOR_X, XOR_Y
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    port = MLP(loss=loss_functions["multiclass_classification"], dtype=torch.float64,
               device="cpu",
               hparams=mlp.Hyperparameters(dims=[4, 3, 3], activations=[mlp.sigmoid, None]))
    ref = JMLP(loss=jloss_functions["multiclass_classification"], dtype=jnp.float64,
               hparams=jmlp.Hyperparameters(dims=[4, 3, 3], activations=[jmlp.sigmoid, None]))
    assert np.array_equal(np.asarray(JXYDataset.from_eeyore("iris", yonehot=True).x), ds.x)
    return port, ref, ds.x, ds.y


def samplers(name, sampler="MALA", L=4, **kw):
    port, ref, x, y = problem(name)
    kwargs = {"MALA": {"step": 0.05 if name == "xor" else 0.003},
              "MetropolisHastings": {"scale": 0.3 if name == "xor" else 0.05}}[sampler]
    pp = PowerPosteriorSampler(port, num_chains=L, sampler=sampler, sampler_kwargs=kwargs, **kw)
    jpp = JPP(ref, num_chains=L, sampler=sampler, sampler_kwargs=kwargs, **kw)
    return pp, jpp, x, y


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def start(pp, jpp, x, y, seed=0):
    thetas = 0.5 * np.random.default_rng(seed).normal(size=(pp.num_chains, pp.model.num_params))
    state = pp.init(t(thetas), t(x), t(y))
    jstate = jpp.init(jnp.asarray(thetas), jnp.asarray(x), jnp.asarray(y))
    return state, jstate


def assert_inner_equal(inner, jinner, fields=("sample", "target_val", "grad_val", "accepted")):
    for f in fields:
        if hasattr(jinner, f):
            np.testing.assert_allclose(getattr(inner, f).numpy(), np.asarray(getattr(jinner, f)),
                                       **F64)


@pytest.mark.parametrize("L", [1, 4, 7])
def test_ladder_and_swap_probabilities_equal_jax(L):
    np.testing.assert_allclose(default_temperatures(L), jdefault_temperatures(L), rtol=1e-12)
    np.testing.assert_allclose(categorical_swap_probs(L, 0.7), jcategorical_swap_probs(L, 0.7),
                               rtol=1e-12)
    assert default_temperatures(L)[-1] == 1.0


@pytest.mark.parametrize("name,sampler", [("xor", "MALA"), ("iris", "MALA"),
                                          ("xor", "MetropolisHastings")])
def test_init_is_the_tempered_state_of_jax(name, sampler):
    pp, jpp, x, y = samplers(name, sampler)
    state, jstate = start(pp, jpp, x, y)
    assert_inner_equal(state.inner, jstate.inner, ("sample", "target_val", "grad_val"))
    one = pp.init(t(np.full(pp.model.num_params, 0.2)), t(x), t(y))  # one theta, every rung
    assert one.inner.sample.shape == (4, pp.model.num_params)
    np.testing.assert_allclose(one.inner.target_val.numpy() / pp.temperatures.numpy(),
                               np.full(4, one.inner.target_val[-1].item()), rtol=1e-12)


@pytest.mark.parametrize("name,sampler", [("xor", "MALA"), ("iris", "MALA"),
                                          ("xor", "MetropolisHastings"),
                                          ("iris", "MetropolisHastings")])
def test_within_step_with_jax_draws_equals_jax(name, sampler):
    """One batched step at every temperature against JAX's vmap of one
    kernel per temperature, on the normals (MALA), proposals (MH) and
    uniforms that JAX's per-chain keys give."""
    pp, jpp, x, y = samplers(name, sampler)
    state, jstate = start(pp, jpp, x, y, seed=1)
    key = jax.random.PRNGKey(3)
    want = jpp._within_moves(key, jstate.inner, jnp.asarray(x), jnp.asarray(y), 0)
    firsts, uniforms = [], []
    for i, k in enumerate(jax.random.split(key, pp.num_chains)):
        key_prop, key_acc = jax.random.split(k)
        sample = jstate.inner.sample[i]
        if sampler == "MALA":
            firsts.append(jax.random.normal(key_prop, sample.shape, dtype=jnp.float64))
        else:
            firsts.append(jkernels.NormalKernel(pp.sampler_kwargs["scale"]).sample(key_prop,
                                                                                   sample))
        uniforms.append(jax.random.uniform(key_acc, dtype=jnp.float64))
    got = pp._within_moves(state.inner, t(x), t(y), draws=(t(firsts), t(uniforms)))
    assert_inner_equal(got, want)


@pytest.mark.parametrize("iteration", [0, 10])
@pytest.mark.parametrize("sampler", ["MALA", "MetropolisHastings"])
def test_even_odd_round_with_jax_uniforms_equals_jax(sampler, iteration):
    """Parity (iteration // between_step) % 2 = 0 and 1; each pair tests the
    uniform of fold_in(key, its lower member)."""
    pp, jpp, x, y = samplers("iris", sampler, L=5, between_step=10, swap_scheme="even_odd")
    state, jstate = start(pp, jpp, x, y, seed=2)
    key = jax.random.PRNGKey(5)
    want = jpp._between_moves_even_odd(key, jstate.inner, jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(iteration))
    idx = np.arange(5)
    parity = (iteration // 10) % 2
    partner = np.clip(np.where(idx % 2 == parity, idx + 1, idx - 1), 0, 4)
    uniforms = [jax.random.uniform(jax.random.fold_in(key, int(p)), dtype=jnp.float64)
                for p in np.minimum(idx, partner)]
    got = pp._between_moves_even_odd(state.inner, t(x), t(y), iteration, uniforms=t(uniforms))
    assert_inner_equal(got, want)


@pytest.mark.parametrize("sampler", ["MALA", "MetropolisHastings"])
def test_categorical_sweep_with_jax_draws_equals_jax(sampler):
    """The serial sweep's partners and uniforms replayed from JAX's key
    splits (split into three, choice from P[i], uniform)."""
    pp, jpp, x, y = samplers("xor", sampler, L=5, b=0.3)
    state, jstate = start(pp, jpp, x, y, seed=3)
    key = jax.random.PRNGKey(7)
    want = jpp._between_moves_categorical(key, jstate.inner, jnp.asarray(x), jnp.asarray(y))
    partners, uniforms = [], []
    k = key
    for i in range(5):
        k, key_j, key_acc = jax.random.split(k, 3)
        partners.append(int(jax.random.choice(key_j, 5, p=jpp._swap_probs[i])))
        uniforms.append(jax.random.uniform(key_acc, dtype=jnp.float64))
    got = pp._between_moves_categorical(state.inner, t(x), t(y), partners=partners,
                                        uniforms=t(uniforms))
    assert_inner_equal(got, want)
    # the sweep swapped something, and drawn partners are never the chain itself
    assert not np.array_equal(got.sample.numpy(), state.inner.sample.numpy())
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):  # partners and uniforms drawn from a generator
        drawn = pp._between_moves_categorical(state.inner, t(x), t(y), generator=gen)
        assert sorted(drawn.sample[:, 0].tolist()) == sorted(state.inner.sample[:, 0].tolist())


def test_equal_temperature_ladder_swaps_every_valid_pair():
    """All-equal temperatures make the even/odd log-rate exactly 0, so every
    valid pair swaps (tests/test_samplers.py:265-282)."""
    port = problem("xor")[0]
    pp = PowerPosteriorSampler(port, num_chains=5, sampler="MALA", sampler_kwargs={"step": 0.3},
                               temperature=[1.0] * 5, between_step=1, swap_scheme="even_odd")
    thetas = torch.arange(5, dtype=torch.float64)[:, None].expand(5, 9).contiguous()
    state = pp.init(thetas, t(XOR_X), t(XOR_Y))
    gen = torch.Generator().manual_seed(0)
    for iteration, order in ((0, [1, 0, 3, 2, 4]), (1, [0, 2, 1, 4, 3])):
        inner = pp._between_moves_even_odd(state.inner, t(XOR_X), t(XOR_Y), iteration,
                                           generator=gen)
        assert inner.sample[:, 0].tolist() == order
        torch.testing.assert_close(inner.target_val, state.inner.target_val[order], **F64)
        torch.testing.assert_close(inner.grad_val, state.inner.grad_val[order], **F64)


def test_several_ladders_in_one_state_equal_separate_ladders():
    """[G L, P] thetas are G ladders: the within step and the even/odd round
    never pair chains of two ladders, and each ladder equals its own run on
    the same draws."""
    pp, _, x, y = samplers("xor", "MALA", L=4, between_step=1, swap_scheme="even_odd")
    rng = np.random.default_rng(4)
    thetas = t(0.5 * rng.normal(size=(12, 9)))
    noise, uniforms, pair_u = t(rng.normal(size=(12, 9))), t(rng.uniform(size=12)), \
        t(rng.uniform(size=12))
    both = pp.init(thetas, t(x), t(y)).inner
    both = pp._within_moves(both, t(x), t(y), draws=(noise, uniforms))
    for iteration in (0, 1):
        both = pp._between_moves_even_odd(both, t(x), t(y), iteration, uniforms=pair_u)
    for g in range(3):
        rows = slice(4 * g, 4 * g + 4)
        one = pp.init(thetas[rows], t(x), t(y)).inner
        one = pp._within_moves(one, t(x), t(y), draws=(noise[rows], uniforms[rows]))
        for iteration in (0, 1):
            one = pp._between_moves_even_odd(one, t(x), t(y), iteration, uniforms=pair_u[rows])
        for f in ("sample", "target_val", "grad_val"):
            torch.testing.assert_close(getattr(both, f)[rows], getattr(one, f), **F64)
    with pytest.raises(ValueError, match="whole ladders"):
        pp.init(thetas[:10], t(x), t(y))
    with pytest.raises(ValueError, match="one ladder"):
        pp._between_moves_categorical(pp.init(thetas, t(x), t(y)).inner, t(x), t(y))


COLD_ITERS, COLD_BURNIN, COLD_SEEDS = 700, 200, 16


@functools.lru_cache(maxsize=None)
def jax_cold_rung():
    """JAX's scanned XOR ladder (MALA step 0.05, L=4, swaps every 5) over
    COLD_SEEDS keys: the cold rung's ``moments`` [R, 18] and acceptance per
    run [R]."""
    _, jpp, x, y = samplers("xor", "MALA", L=4, between_step=5, swap_scheme="even_odd")
    cold = jpp.default_indicator()
    jdata = jas_schedule((jnp.asarray(x), jnp.asarray(y)))  # one schedule: one compile
    means, acc = [], []
    for seed in range(COLD_SEEDS):
        jchains = jpp.run(jax.random.PRNGKey(100 + seed), jnp.asarray(0.1 * np.ones(9)), jdata,
                          COLD_ITERS, COLD_BURNIN, backend="scan")
        means.append(moments(np.asarray(jchains.get_chain(cold))))
        acc.append(float(np.asarray(jchains.get_chain(cold, key="accepted")).mean()))
    return np.array(means), np.array(acc)


def moments(samples):
    """Posterior means of theta and of theta^2 over a chain's samples [...,
    kept, P]: XOR's posterior is symmetric, so its first moments are near 0
    whatever the sampler, and the second ones tell a wrong ladder apart."""
    samples = np.asarray(samples, dtype=np.float64)
    return np.concatenate([samples.mean(-2), (samples ** 2).mean(-2)], axis=-1)


def assert_cold_rung_agrees_with_jax(means, acc):
    """Pooled ``moments`` of independent ladders' cold rungs within 5 pooled
    standard errors of JAX's, and the mean acceptance within 0.05."""
    a, b = np.asarray(means), jax_cold_rung()[0]
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    assert np.max(np.abs(a.mean(0) - b.mean(0)) / se) < 5.0
    assert abs(np.mean(acc) - np.mean(jax_cold_rung()[1])) < 0.05


def test_run_scan_agrees_with_jax_on_the_cold_rung():
    """``run(backend="scan")`` on XOR, L=4: the cold rung's pooled posterior
    moments over independent ladders within 5 pooled standard errors of
    JAX's scanned ladder, and the cold rung's acceptance within 0.05."""
    pp, _, x, y = samplers("xor", "MALA", L=4, between_step=5, swap_scheme="even_odd")
    cold = pp.default_indicator()
    port_means, port_acc = [], []
    for seed in range(COLD_SEEDS):
        chains = pp.run(torch.Generator().manual_seed(seed), t(0.1 * np.ones(9)), (t(x), t(y)),
                        COLD_ITERS, COLD_BURNIN, backend="scan")
        assert chains.num_chains() == 4
        assert chains.get_chain(cold).shape == (COLD_ITERS - COLD_BURNIN, 9)
        port_means.append(moments(chains.get_chain(cold).numpy()))
        port_acc.append(chains.get_chain(cold, key="accepted").double().mean().item())
    assert_cold_rung_agrees_with_jax(port_means, port_acc)


@pytest.mark.parametrize("backend,ladders", [("auto", 256), ("resident", 32)])
def test_kernel_path_agrees_with_jax_on_the_cold_rung(backend, ladders):
    """The kernel path's plain tempering (``run(backend=..., platform="cuda")``
    on CPU tensors: the dense move under ``auto``, the staged one under
    ``resident``, float32) on the same ladder: the cold rungs of every ladder
    of its block against JAX's scanned ladder, as above."""
    pp, _, x, y = samplers("xor", "MALA", L=4, between_step=5, swap_scheme="even_odd")
    chains = pp.run(torch.Generator().manual_seed(0), t(0.1 * np.ones(9)), (t(x), t(y)),
                    COLD_ITERS, COLD_BURNIN, backend=backend, platform="cuda", all_ladders=True)
    assert chains.num_chains() == 4 * ladders
    samples = chains.get_samples()[pp.default_indicator()::4]  # [ladders, kept, 9]
    flags = chains.tensor("accepted")[pp.default_indicator()::4]
    assert samples.dtype == torch.float32 and bool(torch.isfinite(samples).all())
    assert_cold_rung_agrees_with_jax(moments(samples.numpy()), flags.double().mean(1).numpy())


def test_tempered_models_raise_and_population_kernels_are_abstract():
    port = problem("xor")[0]
    port.temperature = 0.5
    with pytest.raises(ValueError, match="untempered"):
        PowerPosteriorSampler(port, num_chains=4)
    port.temperature = None
    with pytest.raises(ValueError, match="len"):
        PowerPosteriorSampler(port, num_chains=4, temperature=[0.5, 1.0])
    pp = PowerPosteriorSampler(port, num_chains=6)
    assert pp.default_indicator() == 5
    with pytest.raises(ValueError, match="unsupported ladder sampler"):
        PowerPosteriorSampler(port, num_chains=2, sampler="HMC").init(
            torch.zeros(9, dtype=torch.float64), t(XOR_X), t(XOR_Y))
    base = PopulationKernel(port)
    with pytest.raises(NotImplementedError):
        base.init(None, None, None)
    with pytest.raises(NotImplementedError):
        base.step(None, None, None, 0)


def test_sample_population_records_chain_major():
    pp, _, x, y = samplers("xor", "MetropolisHastings", L=3, between_step=2)
    out, state = sample_population(pp, torch.Generator().manual_seed(1),
                                   t(np.zeros((3, 9))), (t(x), t(y)), 12, 4,
                                   record_keys=("sample", "target_val"), return_arrays=True,
                                   return_state=True)
    assert out["sample"].shape == (3, 8, 9) and out["target_val"].shape == (3, 8)
    torch.testing.assert_close(out["sample"][:, -1], state.inner.sample)
    np.testing.assert_allclose(out["target_val"][:, -1].numpy() / pp.temperatures.numpy(),
                               pp.model.log_target(state.inner.sample, t(x), t(y)).numpy(),
                               rtol=1e-12)
    assert math.isfinite(float(out["target_val"].sum()))
