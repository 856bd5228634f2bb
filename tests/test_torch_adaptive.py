"""Port, the adaptive samplers on the generic path: ``samplers/am.py``,
``samplers/ram.py`` and ``samplers/demc.py`` against the JAX package's AM,
RAM and DEMC. In float64 on the CPU, with JAX's own draws given (the
normals and uniforms of its key splits, ``am.py:68`` and ``ram.py:48``, and
DEMC's partners), one step and 50-step trajectories equal JAX's in every
state field to rtol 1e-12: trajectories that cross the ``t0`` gate, the
first acceptance and ``offset > 0``, on a bivariate normal and XOR
MLP(2,2,1), and the failure guards (``AM(cov0=-I)`` takes the isotropic
step, ``RAM(a=2.0)`` keeps its factor) bit for bit where JAX masks. The
partners are distinct over 10^4 walkers. Statistically, 256 chains a run
meet JAX's own thresholds on the bivariate normal (tests/test_samplers.py):
AM and RAM moments, RAM's acceptance 0.234 +- 0.06, and DEMC's moments."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import DistributionModel as JDistributionModel
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.samplers import AM as JAM
from eeyore_tpu.samplers import DEMC as JDEMC
from eeyore_tpu.samplers import RAM as JRAM
from eeyore_tpu.stats import softabs as jsoftabs
from eeyore_tpu_torch.models import MLP, DistributionModel, loss_functions, mlp
from eeyore_tpu_torch.samplers import AM, DEMC, RAM, sample_chains, sample_population
from eeyore_tpu_torch.samplers.demc import shift_partners
from eeyore_tpu_torch.stats import softabs

COV = np.array([[1.0, 0.5], [0.5, 1.0]])
PREC = np.linalg.inv(COV)
XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])
EXACT = dict(rtol=1e-12, atol=1e-12)
C = 8
STEPS = 50


def t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def models(name):
    """(port model, JAX model, x, y), both float64."""
    if name == "bvn":
        prec = t(PREC)
        port = DistributionModel(lambda th, x, y: -0.5 * ((th @ prec) * th).sum(-1), 2,
                                 dtype=torch.float64, device="cpu")
        ref = JDistributionModel(lambda th, x, y: -0.5 * th @ jnp.asarray(PREC) @ th,
                                 num_params=2)
        return port, ref, np.zeros((1, 0)), np.zeros((1, 0))
    port = MLP(loss=loss_functions["binary_classification"], dtype=torch.float64, device="cpu",
               hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
    ref = JMLP(loss=jloss_functions["binary_classification"], dtype=jnp.float64,
               hparams=jmlp.Hyperparameters(dims=[2, 2, 1]))
    return port, ref, XOR_X, XOR_Y


def theta0s(P, seed=0, scale=2.0):
    return np.random.default_rng(seed).normal(size=(C, P)) * scale


def jax_keys(seed, iteration):
    """One key a chain for an iteration, as a runner folds them in."""
    base = jax.random.fold_in(jax.random.PRNGKey(seed), iteration)
    return jax.random.split(base, C)


@functools.partial(jax.jit, static_argnums=1)
def am_draw_arrays(keys, P):
    def one(k):
        kz, kmix, kacc = jax.random.split(k, 3)
        return (jax.random.normal(kz, (P,), dtype=jnp.float64),
                jax.random.uniform(kmix, dtype=jnp.float64),
                jax.random.uniform(kacc, dtype=jnp.float64))
    return jax.vmap(jax.vmap(one))(keys)


@functools.partial(jax.jit, static_argnums=1)
def ram_draw_arrays(keys, P):
    def one(k):
        kz, kacc = jax.random.split(k)
        return (jax.random.normal(kz, (P,), dtype=jnp.float64),
                jax.random.uniform(kacc, dtype=jnp.float64))
    return jax.vmap(jax.vmap(one))(keys)


@jax.jit
def step_keys(seed, start):
    """The keys [STEPS, C] of iterations start, start + 1, ..."""
    return jax.vmap(lambda i: jax_keys(seed, i))(start + jnp.arange(STEPS))


def am_draws(keys, P):
    """AM's z [S, C, P], u_mix [S, C], u_acc [S, C] from its split
    (am.py:68), for keys [S, C]. Compiled: the draws are integer Threefry
    words and ``jax.random``'s own compiled transforms, the same bits as op
    by op."""
    return [t(np.asarray(v)) for v in am_draw_arrays(keys, P)]


def ram_draws(keys, P):
    """RAM's z [S, C, P], u_acc [S, C] from its split (ram.py:48)."""
    return [t(np.asarray(v)) for v in ram_draw_arrays(keys, P)]


def assert_state_equal(port, ref, exact=False):
    assert port._fields == ref._fields
    for name, got, want in zip(port._fields, port, ref):
        want = np.asarray(want)
        if exact:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, err_msg=name, **EXACT)


def replay(port_kernel, ref_kernel, name, draws, start, num_steps, seed=0, compare=True):
    """Run both kernels ``num_steps`` iterations from ``start`` on the same
    draws, comparing every state after every step (unless ``compare`` is
    False); returns both kernels' states after each step."""
    port_model, ref_model, x, y = models(name)
    port_kernel, ref_kernel = port_kernel(port_model), ref_kernel(ref_model)
    thetas = theta0s(port_model.num_params, seed)
    xt, yt = t(x), t(y)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    port = port_kernel.init(t(thetas), xt, yt)
    ref = jax.jit(jax.vmap(lambda th: ref_kernel.init(th, xj, yj)))(jnp.asarray(thetas))
    # op by op, as the port runs: a compiled step may fuse a multiply and an
    # add into one rounding, and AM's covariance estimate (a difference of
    # nearly equal sums early on) would carry that ulp far
    step = jax.vmap(ref_kernel.step, in_axes=(0, 0, None, None, None))
    history = [(port, ref)]
    iterations = range(start, start + num_steps)
    # the draws of STEPS iterations, whatever the run's length: one shape
    # for JAX to compile
    keys = step_keys(seed, start)
    given = draws[1](keys, port_model.num_params)
    for s, i in enumerate(iterations):
        port, _ = port_kernel.step_fn(port, xt, yt, i,
                                      **{k: v[s] for k, v in zip(draws[0], given)})
        ref, _ = step(keys[s], ref, xj, yj, jnp.int32(i))
        if compare:
            assert_state_equal(port, ref)
        history.append((port, ref))
    return history


AM_DRAWS = (("z", "u_mix", "u_acc"), am_draws)
RAM_DRAWS = (("z", "u_acc"), ram_draws)


def test_one_step_equals_jax(name="xor"):
    # the adapted proposal from the first step: t0 = 0
    replay(lambda m: AM(m, t0=0), lambda m: JAM(m, t0=0), name, AM_DRAWS, 0, 1)
    replay(lambda m: RAM(m), lambda m: JRAM(m), name, RAM_DRAWS, 0, 1)


# t0 past the parameters' count, so that the first estimate has full rank:
# the factor of a singular estimate is a rounding's choice, and the chains of
# the two packages would part there
AM_T0 = {"bvn": 15, "xor": 30}


@pytest.mark.parametrize("offset", [0, 3])
def test_am_trajectory_equals_jax(offset, name="xor"):
    """50 iterations from ``offset``: isotropic until ``t0``, the adapted
    mixture after; the first acceptances on the way."""
    t0 = AM_T0[name]
    history = replay(lambda m: AM(m, t0=t0, offset=offset, c=0.5),
                     lambda m: JAM(m, t0=t0, offset=offset, c=0.5), name, AM_DRAWS, offset, 50)
    first, last = history[0][0], history[-1][0]
    assert int(first.num_accepted.sum()) == 0 < int(last.num_accepted.min())
    assert not torch.allclose(last.cov, first.cov)


@pytest.mark.parametrize("offset", [0, 3])
def test_ram_trajectory_equals_jax(offset, name="xor"):
    history = replay(lambda m: RAM(m, offset=offset), lambda m: JRAM(m, offset=offset),
                     name, RAM_DRAWS, offset, 50)
    assert not torch.equal(history[-1][0].chol_cov, history[0][0].chol_cov)


def test_am_with_softabs_equals_jax():
    transform = functools.partial(softabs, a=1000.0)
    jtransform = functools.partial(jsoftabs, a=1000.0)
    replay(lambda m: AM(m, transform=transform, t0=AM_T0["xor"], c=0.5),
           lambda m: JAM(m, transform=jtransform, t0=AM_T0["xor"], c=0.5), "xor", AM_DRAWS,
           AM_T0["xor"] - 5, 15)


def test_softabs_of_a_batch_is_each_matrix_alone():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5, 3, 3))
    a = t(a + np.swapaxes(a, 1, 2))
    batch = softabs(a, 10.0)
    for k in range(5):
        np.testing.assert_allclose(batch[k].numpy(), softabs(a[k], 10.0).numpy(), **EXACT)


def test_am_not_positive_definite_cov0_takes_the_isotropic_step():
    """cov0 = -I has no factor: until a chain's first acceptance counts, its
    proposals are the isotropic ones, and its samples are JAX's bit for
    bit. (After it, the estimate from one or two distinct samples is
    singular, and its factor a rounding's choice.)"""
    history = replay(lambda m: AM(m, cov0=-np.eye(9), t0=0, c=0.3),
                     lambda m: JAM(m, cov0=-np.eye(9), t0=0, c=0.3), "xor", AM_DRAWS, 0, 12,
                     compare=False)
    checked = 0
    for (before, _), (port, ref) in zip(history, history[1:]):
        fresh = (before.num_accepted == 0).numpy()
        np.testing.assert_array_equal(port.sample.numpy()[fresh], np.asarray(ref.sample)[fresh])
        np.testing.assert_array_equal(port.cov.numpy()[fresh], np.asarray(ref.cov)[fresh])
        checked += int(fresh.sum())
    assert checked > C  # some chains went on past their first step without accepting


def test_ram_failed_factor_keeps_the_old_one():
    """a = 2 sends h (rate - a) to -1 or below while h = min(1, 9 it^-0.7)
    is 1 (it up to 23): the updated matrix is not positive definite, and a
    chain keeps its factor. Wherever JAX's mask kept a factor, the port's
    chain (from the same state) kept it too, bit for bit, where the
    proposal was rejected (so rate < 1 and the matrix has a negative
    eigenvalue). An accepted proposal may have rate = 1 exactly, where the
    matrix is singular and whether its factorisation fails is a rounding's
    choice in either package: those chains are not compared."""
    history = replay(lambda m: RAM(m, a=2.0), lambda m: JRAM(m, a=2.0), "xor", RAM_DRAWS, 0,
                     23, compare=False)
    kept = 0
    for (port0, ref0), (port, ref) in zip(history, history[1:]):
        same = np.all(port0.chol_cov.numpy() == np.asarray(ref0.chol_cov), axis=(1, 2))
        jax_kept = np.all(np.asarray(ref.chol_cov) == np.asarray(ref0.chol_cov), axis=(1, 2))
        rejected = np.asarray(ref.accepted) == 0
        for c in np.flatnonzero(same & jax_kept & rejected):
            np.testing.assert_array_equal(port.chol_cov[c].numpy(), port0.chol_cov[c].numpy())
            kept += 1
    assert kept >= 5 * C


def demc_draws(key, num, P):
    """DEMC's partners, z and u from its split (demc.py:46-79), and the raw
    partner draws before the exclusion shift."""
    key_p, key_z, key_acc = jax.random.split(key, 3)
    key_a, key_b = jax.random.split(key_p)
    raw = (jax.random.randint(key_a, (num,), 0, num - 1),
           jax.random.randint(key_b, (num,), 0, num - 2))
    z = jax.random.normal(key_z, (num, P), dtype=jnp.float64)
    u = jax.random.uniform(key_acc, (num,), dtype=jnp.float64)
    return raw, z, u


@pytest.mark.parametrize("c", [None, 0.4])
def test_demc_trajectory_equals_jax(c, name="xor"):
    port_model, ref_model, x, y = models(name)
    port_kernel, ref_kernel = DEMC(port_model, c=c, scale=0.01), JDEMC(ref_model, c=c, scale=0.01)
    num, P = C, port_model.num_params
    thetas = np.random.default_rng(4).normal(size=(num, P))
    xt, yt, xj, yj = t(x), t(y), jnp.asarray(x), jnp.asarray(y)
    port = port_kernel.init(t(thetas), xt, yt)
    ref = ref_kernel.init(jnp.asarray(thetas), xj, yj)
    step = ref_kernel.step
    for i in range(10):
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        raw, z, u = demc_draws(key, num, P)
        a, b = shift_partners(*(torch.as_tensor(np.array(r)) for r in raw))
        ja, jb = ref_kernel._partners(jax.random.split(key, 3)[0], num)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        port, _ = port_kernel.step_fn(port, xt, yt, partners=(a, b), z=t(np.asarray(z)),
                                      u=t(np.asarray(u)))
        ref, _ = step(key, ref, xj, yj)
        assert_state_equal(port, ref)


@pytest.mark.parametrize("num", [3, 10_000])
def test_demc_partners_distinct(num):
    kernel = DEMC(models("bvn")[0])
    gen = torch.Generator().manual_seed(0)
    idx = torch.arange(num)
    for _ in range(10_000 // num):
        a, b = kernel._partners(gen, num)
        assert bool(((a != idx) & (b != idx) & (a != b)).all())
        assert int(a.min()) >= 0 and int(a.max()) < num and int(b.max()) < num


# ---- statistics on the bivariate normal (tests/test_samplers.py thresholds) ----

def check_moments(samples, mean_tol, cov_tol):
    samples = samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(samples.mean(axis=0), np.zeros(2), atol=mean_tol)
    np.testing.assert_allclose(np.cov(samples, rowvar=False), COV, atol=cov_tol)


STAT_CHAINS, STAT_ITERS, STAT_BURNIN = 256, 1200, 600


@pytest.mark.parametrize("make", [lambda m: AM(m), lambda m: RAM(m)], ids=["am", "ram"])
def test_recovers_bvn(make):
    model, _, x, y = models("bvn")
    start = torch.tensor([[2.0, -2.0]], dtype=torch.float64).expand(STAT_CHAINS, 2)
    chains = sample_chains(make(model), torch.Generator().manual_seed(42), start, (t(x), t(y)),
                           STAT_ITERS, STAT_BURNIN, backend="scan")
    check_moments(chains.get_samples(), mean_tol=0.12, cov_tol=0.2)
    acceptance = chains.tensor("accepted").double().mean().item()
    assert 0.05 < acceptance <= 1.0
    if isinstance(make(model), RAM):
        assert abs(acceptance - 0.234) < 0.06


def test_demc_recovers_bvn():
    model, _, x, y = models("bvn")
    gen = torch.Generator().manual_seed(5)
    start = 2.0 * torch.randn(STAT_CHAINS, 2, generator=gen, dtype=torch.float64)
    chains = sample_population(DEMC(model), gen, start, (t(x), t(y)), STAT_ITERS, STAT_BURNIN)
    check_moments(chains.get_samples(), mean_tol=0.08, cov_tol=0.15)
