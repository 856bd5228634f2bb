"""Port, tempered SMC: ``samplers/smc.py`` against the JAX package's
``SMCSampler``. In float64 with JAX's own draws given (the normals and
uniforms of its per-particle key splits, the resampling uniform of its
``key_res``), ``log_ess``, ``systematic_resample_indices``, ``_next_beta``
(a bisection, the full jump and the forced 1e-6 advance), ``_mutate`` (MALA
and MH, on an MLP and on a ``DistributionModel`` with a base) and one
``_stage_core`` equal JAX's (1e-10). The generic path meets JAX's own SMC
tests on the conjugate normal (the closed-form posterior and evidence, fixed
and adaptive) with JAX's tolerances. The kernel path (``run(backend="auto",
platform="cuda")`` on CPU tensors: the SMC runner on the plain mutation pass,
float32) agrees with JAX's scanned SMC over 8 seeds a side on XOR MLP(2,2,1)
and a 30-row iris MLP(4,3,3), fixed and adaptive: weighted posterior means
and log-evidence within 5 standard errors of the difference of the two
8-seed means (the spread over seeds, which counts the resampling's
correlations, where the weights' ESS does not)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.models import IIDNormalPrior as JIIDNormalPrior
from eeyore_tpu.models import DistributionModel as JDistributionModel
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.models.model import BayesianModel as JBayesianModel
from eeyore_tpu.samplers import SMCSampler as JSMCSampler
from eeyore_tpu.samplers.smc import log_ess as jlog_ess
from eeyore_tpu.samplers.smc import systematic_resample_indices as jsystematic
from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, DistributionModel, IIDNormalPrior, loss_functions, mlp
from eeyore_tpu_torch.models.model import BayesianModel
from eeyore_tpu_torch.samplers import SMCSampler, SMCState, systematic_resample_indices
from eeyore_tpu_torch.samplers.smc import log_ess

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])
F64 = dict(rtol=1e-10, atol=1e-10)
PREC = np.array([[1.0, 0.5], [0.5, 1.0]])
EMPTY = (np.zeros((1, 0)), np.zeros((1, 0)))


def t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def close(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or F64))


class ConjugateNormal(BayesianModel):
    """theta ~ N(0, 1), y | theta ~ N(theta, 1): the closed-form posterior
    and evidence of tests/test_samplers.py::_ConjugateNormal."""

    def __init__(self):
        super().__init__(loss=lambda pred, y: 0.5 * torch.sum((pred - y) ** 2, dim=(-2, -1)),
                         dtype=torch.float64, device="cpu")
        self.num_params = 1
        self.prior = IIDNormalPrior.standard(1, dtype=torch.float64, device="cpu")

    def forward(self, theta, x):
        return theta[..., None, :].expand(*theta.shape[:-1], x.shape[0], 1)


class JConjugateNormal(JBayesianModel):
    def __init__(self):
        super().__init__(loss=lambda pred, y: 0.5 * jnp.sum((pred - y) ** 2))
        self.num_params = 1
        self.prior = JIIDNormalPrior.standard(1)

    def forward(self, theta, x):
        return jnp.broadcast_to(theta, x.shape[:1] + (1,))


def problem(name, dtype=torch.float64):
    """(port model, JAX model in float64, x, y)."""
    if name == "xor":
        port = MLP(loss=loss_functions["binary_classification"], dtype=dtype, device="cpu",
                   hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
        ref = JMLP(loss=jloss_functions["binary_classification"], dtype=jnp.float64,
                   hparams=jmlp.Hyperparameters(dims=[2, 2, 1]))
        return port, ref, XOR_X, XOR_Y
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    port = MLP(loss=loss_functions["multiclass_classification"], dtype=dtype, device="cpu",
               hparams=mlp.Hyperparameters(dims=[4, 3, 3], activations=[mlp.sigmoid, None]))
    ref = JMLP(loss=jloss_functions["multiclass_classification"], dtype=jnp.float64,
               hparams=jmlp.Hyperparameters(dims=[4, 3, 3], activations=[jmlp.sigmoid, None]))
    return port, ref, ds.x[::5], ds.y[::5]  # 30 rows, every class


def bvn_pair(**kw):
    """A 2-d Gaussian DistributionModel with a N(0, 9 I) base: (port, JAX)."""
    port = SMCSampler(
        DistributionModel(lambda th, x, y: -0.5 * ((th @ t(PREC)) * th).sum(-1), 2,
                          dtype=torch.float64, device="cpu"),
        init_sampler=lambda gen, n: 3.0 * torch.randn(n, 2, generator=gen, dtype=torch.float64),
        base_log_pdf=lambda th: (-0.5 * th ** 2 / 9.0).sum(-1), **kw)
    ref = JSMCSampler(
        JDistributionModel(lambda th, x, y: -0.5 * th @ jnp.asarray(PREC) @ th, num_params=2),
        init_sampler=lambda key, n: 3.0 * jax.random.normal(key, (n, 2)),
        base_log_pdf=lambda th: jnp.sum(-0.5 * th ** 2 / 9.0), **kw)
    return port, ref


def jax_mutation_draws(key, N, P, S):
    """The normals [S, N, P] and uniforms [S, N] of JAX's ``_mutate``: key
    -> one key a particle -> one a step -> (normal key, uniform key)."""
    def particle(k):
        def step(ks):
            k1, k2 = jax.random.split(ks)
            return (jax.random.normal(k1, (P,), dtype=jnp.float64),
                    jax.random.uniform(k2, dtype=jnp.float64))
        return jax.vmap(step)(jax.random.split(k, S))

    z, u = jax.vmap(particle)(jax.random.split(key, N))
    return t(np.swapaxes(np.asarray(z), 0, 1)), t(np.asarray(u).T)


def test_log_ess_and_systematic_resampling_equal_jax():
    rng = np.random.default_rng(0)
    lw = 3.0 * rng.normal(size=64)
    close(log_ess(t(lw)), jlog_ess(jnp.asarray(lw)))
    w = np.exp(lw - lw.max())
    w /= w.sum()
    for s in range(5):
        key = jax.random.PRNGKey(s)
        u = jax.random.uniform(key, dtype=jnp.float64)
        got = systematic_resample_indices(None, t(w), u=t(u))
        assert np.array_equal(got.numpy(), np.asarray(jsystematic(key, jnp.asarray(w))))


def test_systematic_resample_unbiased():
    w = t([0.5, 0.25, 0.125, 0.125])
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(4)
    for _ in range(200):
        counts += np.bincount(systematic_resample_indices(gen, w).numpy(), minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), w.numpy(), atol=0.02)


@pytest.mark.parametrize("case", ["bisect", "full_jump", "forced_minimum"])
def test_next_beta_equals_jax(case):
    rng = np.random.default_rng(1)
    n = 256
    lw = 0.5 * rng.normal(size=n)
    pots = {"bisect": 3.0, "full_jump": 1e-3, "forced_minimum": 1e9}[case] * rng.normal(size=n)
    port = SMCSampler(ConjugateNormal(), n, betas="adaptive", adaptive_target_ess=0.6)
    ref = JSMCSampler(JConjugateNormal(), n, betas="adaptive", adaptive_target_ess=0.6)
    got = port._next_beta(t(lw), t(pots), t(0.2))
    want = ref._next_beta(jnp.asarray(lw), jnp.asarray(pots), jnp.asarray(0.2))
    close(got, want)
    if case == "full_jump":
        assert float(got) == 1.0
    elif case == "forced_minimum":
        assert float(got) == 0.2 + 1e-6
    else:
        assert 0.2 < float(got) < 1.0


def mutation_pair(name, mutation):
    if name == "bvn":
        port, ref = bvn_pair(num_particles=12, mutation=mutation, mutation_step=1.5,
                             num_mutation_steps=3)
        return port, ref, EMPTY
    port_model, ref_model, x, y = problem(name)
    step = 0.05 if name == "xor" else 0.1
    kw = dict(num_particles=12, mutation=mutation, mutation_step=step, num_mutation_steps=3)
    return SMCSampler(port_model, **kw), JSMCSampler(ref_model, **kw), (x, y)


@pytest.mark.parametrize("name,mutation", [("xor", "MALA"), ("xor", "MH"), ("iris", "MALA"),
                                           ("bvn", "MALA"), ("bvn", "MH")])
def test_mutate_with_jax_draws_equals_jax(name, mutation):
    port, ref, (x, y) = mutation_pair(name, mutation)
    P = port.model.num_params
    particles = 0.7 * np.random.default_rng(2).normal(size=(12, P))
    key = jax.random.PRNGKey(7)
    want = ref._mutate(key, jnp.asarray(particles), 0.4, jnp.asarray(x), jnp.asarray(y))
    noise, uniforms = jax_mutation_draws(key, 12, P, 3)
    got = port._mutate(None, t(particles), 0.4, t(x), t(y), noise=noise, uniforms=uniforms)
    close(got[0], want[0])
    close(got[1], want[1])
    assert 0.0 < float(got[1].mean()) < 1.0


@pytest.mark.parametrize("spread,force", [(4.0, None), (0.01, None), (0.01, True)])
def test_stage_core_with_jax_draws_equals_jax(spread, force):
    """One stage: reweight, resample (the wide weights fall below the ESS
    threshold, the narrow ones do not unless forced), mutate."""
    port_model, ref_model, x, y = problem("xor")
    kw = dict(num_particles=32, mutation="MALA", mutation_step=0.05, num_mutation_steps=2)
    port, ref = SMCSampler(port_model, **kw), JSMCSampler(ref_model, **kw)
    rng = np.random.default_rng(3)
    particles = 0.7 * rng.normal(size=(32, 9))
    lw = spread * rng.normal(size=32)
    pots = np.asarray(jax.vmap(lambda th: ref_model.log_lik(th, jnp.asarray(x),
                                                            jnp.asarray(y)))(particles))
    key_res, key_mut = jax.random.split(jax.random.PRNGKey(11))
    args = (0.1, 0.35)
    want = ref._stage_core(key_res, key_mut, jnp.asarray(particles), jnp.asarray(lw),
                           jnp.asarray(-1.5), jnp.asarray(pots), *args, jnp.asarray(x),
                           jnp.asarray(y),
                           force_resample=None if force is None else jnp.asarray(force))
    noise, uniforms = jax_mutation_draws(key_mut, 32, 9, 2)
    got = port._stage_core(None, t(particles), t(lw), t(-1.5), t(pots), *args, t(x), t(y),
                           force_resample=None if force is None else torch.tensor(force),
                           u=t(jax.random.uniform(key_res, dtype=jnp.float64)), noise=noise,
                           uniforms=uniforms)
    for g, w in zip(got[:3], want[:3]):
        close(g, w)
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        close(got[3][k], want[3][k])
    assert bool(got[3]["resampled"]) == (spread > 1.0 or bool(force))


Y0 = 1.0


def conjugate(betas=None, N=4096, y0=Y0, **kw):
    kw = {"mutation": "MALA", "mutation_step": 0.5, "num_mutation_steps": 3, **kw}
    smc = SMCSampler(ConjugateNormal(), num_particles=N, betas=betas, **kw)
    return smc, (np.zeros((1, 1)), np.full((1, 1), y0))


EXPECTED_LOG_Z = -Y0 ** 2 / (2 * 2.0) - 0.5 * np.log(2.0)


def test_conjugate_posterior_and_evidence():
    smc, data = conjugate()
    state, diags = smc.run(torch.Generator().manual_seed(0), data, backend="scan")
    post_mean = float(SMCSampler.estimate(state)[0])
    # posterior N(y0/2, 1/2); evidence with the unnormalized likelihood
    assert abs(post_mean - Y0 / 2) < 0.05
    var = float(SMCSampler.estimate(state, lambda th: th[:, 0] ** 2)) - post_mean ** 2
    assert abs(var - 0.5) < 0.07
    assert abs(diags["log_evidence"] - EXPECTED_LOG_Z) < 0.05
    assert diags["beta"].shape == (10,) and float(state.beta) == 1.0
    assert torch.equal(state.log_lik, torch.zeros(4096, dtype=torch.float64))


def test_run_accepts_and_ignores_record():
    """JAX's ``run(key, data, jit=True, record=False, backend="auto")`` takes
    ``record`` and never reads it; the port's takes it too, and a run with
    ``record=True`` is the run without it."""
    smc, data = conjugate(N=512)
    state, diags = smc.run(torch.Generator().manual_seed(3), data, record=True)
    again, again_diags = smc.run(torch.Generator().manual_seed(3), data, backend="scan")
    assert torch.equal(state.particles, again.particles)
    assert diags["log_evidence"] == again_diags["log_evidence"]


def test_adaptive_betas_same_evidence_fewer_stages():
    smc, data = conjugate(betas="adaptive", adaptive_target_ess=0.5)
    state, diags = smc.run(torch.Generator().manual_seed(0), data, backend="scan")
    assert abs(float(SMCSampler.estimate(state)[0]) - Y0 / 2) < 0.05
    assert abs(diags["log_evidence"] - EXPECTED_LOG_Z) < 0.05
    assert 1 <= diags["num_stages"] < 10
    betas = diags["beta"].numpy()
    assert betas[-1] == 1.0 and np.all(np.diff(betas) > 0)


def test_adaptive_betas_hard_path_adds_stages():
    easy, easy_data = conjugate(betas="adaptive", N=2048, num_mutation_steps=2)
    hard, hard_data = conjugate(betas="adaptive", N=2048, y0=6.0, num_mutation_steps=2)
    _, diags_easy = easy.run(torch.Generator().manual_seed(1), easy_data, backend="scan")
    state, diags_hard = hard.run(torch.Generator().manual_seed(1), hard_data, backend="scan")
    assert diags_easy["num_stages"] <= diags_hard["num_stages"] < hard.max_stages
    assert abs(float(SMCSampler.estimate(state)[0]) - 3.0) < 0.1  # posterior N(3, 1/2)


def test_adaptive_binding_constraint_resamples_no_stall():
    smc, data = conjugate(betas="adaptive", N=1024, y0=6.0, num_mutation_steps=2)
    _, diags = smc.run(torch.Generator().manual_seed(2), data, backend="scan")
    betas, resampled = diags["beta"].numpy(), diags["resampled"].numpy()
    assert diags["num_stages"] >= 2
    assert np.all(resampled[betas < 1.0])
    assert np.all(np.diff(np.concatenate([[0.0], betas])) > 1e-4)


def test_resampling_triggers_and_ess_tracked():
    smc, data = conjugate(betas=[0.0, 0.5, 1.0], N=512, y0=6.0, mutation="MH",
                          num_mutation_steps=2, ess_threshold=0.9)
    _, diags = smc.run(torch.Generator().manual_seed(0), data, backend="scan")
    assert bool(diags["resampled"].any()) and bool((diags["ess"] > 0).all())


def test_distribution_target_via_base():
    port, _ = bvn_pair(num_particles=1024, mutation="MH", mutation_step=0.5)
    state, _ = port.run(torch.Generator().manual_seed(0), EMPTY, backend="scan")
    assert isinstance(state, SMCState)
    assert bool((SMCSampler.estimate(state).abs() < 0.2).all())


def test_non_bayesian_targets_need_a_base_and_truncation_warns():
    dm = DistributionModel(lambda th, x, y: -0.5 * (th * th).sum(-1), 2, device="cpu")
    with pytest.raises(ValueError, match="init_sampler"):
        SMCSampler(dm, 128, init_sampler=lambda gen, n: torch.randn(n, 2, generator=gen))
    smc, data = conjugate(betas="adaptive", N=256, y0=6.0, num_mutation_steps=1, max_stages=2)
    with pytest.warns(RuntimeWarning, match="TRUNCATED"):
        _, diags = smc.run(torch.Generator().manual_seed(0), data, backend="scan")
    assert diags["num_stages"] == 2


SEEDS = 8
LADDERS = {"fixed": [(i / 10) ** 4 for i in range(11)], "adaptive": "adaptive"}
SIZES = {"xor": dict(num_particles=1024, mutation_step=0.05),
         "iris": dict(num_particles=512, mutation_step=0.003)}


def weighted_means(particles, log_w):
    w = np.exp(log_w - log_w.max())
    return (w / w.sum()) @ particles


@functools.lru_cache(maxsize=None)
def jax_runs(name, ladder):
    """JAX's scanned SMC over SEEDS keys: weighted means [R, P], evidence [R]."""
    _, ref_model, x, y = problem(name)
    smc = JSMCSampler(ref_model, betas=LADDERS[ladder], mutation="MALA", num_mutation_steps=3,
                      **SIZES[name])
    data = (jnp.asarray(x), jnp.asarray(y))  # one pair of arrays: one compile
    means, evidence = [], []
    for seed in range(SEEDS):
        state, diags = smc.run(jax.random.PRNGKey(100 + seed), data, backend="scan")
        means.append(weighted_means(np.asarray(state.particles), np.asarray(state.log_weights)))
        evidence.append(diags["log_evidence"])
    return np.array(means), np.array(evidence)


@pytest.mark.parametrize("ladder", ["fixed", "adaptive"])
@pytest.mark.parametrize("name", ["xor", "iris"])
def test_kernel_path_agrees_with_jax(name, ladder):
    """The kernel path's runner on the plain mutation pass (float32) against
    JAX's scanned SMC: per-seed weighted means and log-evidence, compared by
    their 8-seed means within 5 standard errors of the difference."""
    port_model, _, x, y = problem(name, dtype=torch.float32)
    smc = SMCSampler(port_model, betas=LADDERS[ladder], mutation="MALA", num_mutation_steps=3,
                     **SIZES[name])
    means, evidence = [], []
    for seed in range(SEEDS):
        state, diags = smc.run(torch.Generator().manual_seed(seed), (x, y), backend="auto",
                               platform="cuda")
        assert state.particles.dtype == torch.float32
        assert bool(torch.isfinite(state.particles).all())
        assert not state.log_lik.any()
        means.append(weighted_means(state.particles.double().numpy(),
                                    state.log_weights.double().numpy()))
        evidence.append(diags["log_evidence"])
        assert ("num_stages" in diags) == (ladder == "adaptive")
        assert "final_weight_ess" not in diags and "final_beta" not in diags
    assert len(smc._backend_cache) == 1  # one runner for every seed
    for got, want in ((np.array(means), jax_runs(name, ladder)[0]),
                      (np.array(evidence), jax_runs(name, ladder)[1])):
        se = np.sqrt(got.var(0, ddof=1) / SEEDS + want.var(0, ddof=1) / SEEDS)
        assert np.all(np.abs(got.mean(0) - want.mean(0)) < 5.0 * se + 1e-4)
