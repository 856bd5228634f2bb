"""Port, the rest of the statistics (``stats/{means,metrics,discrepancy,
random}.py``) and the function kernels (``kernels/function_kernels.py``)
against the JAX package's on the same numpy inputs, in float64 to 1e-10:
the streaming means, ``softabs``, the kernels' Gram matrices against their
pointwise ``k`` and JAX's, ``squared_mmd`` (biased and unbiased) and
``mmd``; the index draws by distribution and by never landing on an excluded
index (the cases of tests/test_stats.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eeyore_tpu.stats as jst
import eeyore_tpu_torch.stats as st
from eeyore_tpu.kernels import IsoSEKernel as JIsoSEKernel
from eeyore_tpu.kernels import PeriodicKernel as JPeriodicKernel
from eeyore_tpu.kernels import RQKernel as JRQKernel
from eeyore_tpu_torch.kernels import HomogeneousKernel, IsoSEKernel, PeriodicKernel, RQKernel
from eeyore_tpu_torch.models.losses import binary_cross_entropy

RNG = np.random.default_rng(17)

KERNELS = [(IsoSEKernel(scale=2.0, l=0.5), JIsoSEKernel(scale=2.0, l=0.5)),
           (PeriodicKernel(l=0.8, p=1.5), JPeriodicKernel(l=0.8, p=1.5)),
           (RQKernel(a=2.0), JRQKernel(a=2.0)),
           (RQKernel(scale=0.7, l=1.3, a=0.5), JRQKernel(scale=0.7, l=1.3, a=0.5))]


def t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def test_exports_match_jax():
    names = [n for n in dir(jst) if not n.startswith("_")]
    for name in names:
        if callable(getattr(jst, name)):
            assert callable(getattr(st, name)), name
    assert st.binary_cross_entropy is binary_cross_entropy


# ---- streaming means ----

def test_recursive_mean_equals_jax_and_the_mean():
    xs = RNG.normal(size=(20, 3))
    mean, jmean = torch.zeros(3, dtype=torch.float64), jnp.zeros(3)
    for n, x in enumerate(xs, start=1):
        mean = st.recursive_mean(mean, n, t(x))
        jmean = jst.recursive_mean(jmean, n, jnp.asarray(x))
    np.testing.assert_allclose(mean.numpy(), xs.mean(0), rtol=1e-10)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-12)
    np.testing.assert_allclose(st.recursive_mean(t(xs[0]), 5, t(xs[1]), offset=2).numpy(),
                               np.asarray(jst.recursive_mean(xs[0], 5, xs[1], offset=2)),
                               rtol=1e-12)


@pytest.mark.parametrize("axis", [0, 1])
def test_running_mean_equals_jax(axis):
    xs = RNG.normal(size=(10, 4))
    rm = st.running_mean(t(xs), axis=axis).numpy()
    np.testing.assert_allclose(rm, np.asarray(jst.running_mean(jnp.asarray(xs), axis=axis)),
                               rtol=1e-12)
    n = xs.shape[axis]
    expected = np.cumsum(xs, axis=axis) / np.arange(1, n + 1).reshape((-1, 1) if axis == 0
                                                                      else (1, -1))
    np.testing.assert_allclose(rm, expected, rtol=1e-12)


def test_recursive_cov_keeps_the_closed_form():
    """The recursion keeps cov_k = (sum_i x_i x_i' - (k+1) m_k m_k') / k
    when seeded with cov_1 = -x_1 x_1', and equals JAX's step by step."""
    xs = RNG.normal(size=(30, 2))
    mean, cov = t(xs[0]), -torch.outer(t(xs[0]), t(xs[0]))
    jmean, jcov = jnp.asarray(xs[0]), -jnp.outer(xs[0], xs[0])
    for n in range(2, 31):
        new_mean = st.recursive_mean(mean, n, t(xs[n - 1]))
        cov = st.recursive_cov(cov, new_mean, mean, n, t(xs[n - 1]))
        mean = new_mean
        jnew = jst.recursive_mean(jmean, n, jnp.asarray(xs[n - 1]))
        jcov = jst.recursive_cov(jcov, jnew, jmean, n, jnp.asarray(xs[n - 1]))
        jmean = jnew
        np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-10, atol=1e-12)
    m = xs.mean(0)
    np.testing.assert_allclose(cov.numpy(), (xs.T @ xs - 31 * np.outer(m, m)) / 30, rtol=1e-8)


# ---- softabs ----

def test_softabs_makes_positive_definite_and_equals_jax():
    a = np.diag([2.0, -1.0, 0.5])
    out = st.softabs(t(a), a=1000.0).numpy()
    np.testing.assert_allclose(np.diag(out), [2.0, 1.0, 0.5], rtol=1e-3)
    assert np.all(np.linalg.eigvalsh((out + out.T) / 2) > 0)
    b = RNG.normal(size=(4, 4))
    h = b + b.T
    np.testing.assert_allclose(st.softabs(t(h), a=3.0).numpy(),
                               np.asarray(jst.softabs(jnp.asarray(h), a=3.0)), rtol=1e-10,
                               atol=1e-10)


# ---- function kernels ----

@pytest.mark.parametrize("pair", range(len(KERNELS)))
def test_gram_matches_pointwise_and_jax(pair):
    kernel, jkernel = KERNELS[pair]
    assert isinstance(kernel, HomogeneousKernel)
    x1, x2 = RNG.normal(size=(5, 3)), RNG.normal(size=(4, 3))
    gram = kernel.gram(t(x1), t(x2)).numpy()
    assert gram.shape == (5, 4)
    for i in range(5):
        for j in range(4):
            np.testing.assert_allclose(gram[i, j], kernel.k(t(x1[i]), t(x2[j])).item(),
                                       rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(gram, np.asarray(jkernel.gram(jnp.asarray(x1), jnp.asarray(x2))),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(kernel.sum_K(t(x1), t(x2)).item(),
                               float(jkernel.sum_K(jnp.asarray(x1), jnp.asarray(x2))), rtol=1e-10)
    for diag in (True, False):
        np.testing.assert_allclose(
            kernel.sum_symm_K(t(x1), include_diag=diag).item(),
            float(jkernel.sum_symm_K(jnp.asarray(x1), include_diag=diag)), rtol=1e-10)
    np.testing.assert_allclose(kernel.symm_K(t(x1)).numpy(), kernel.K(t(x1), t(x1)).numpy())
    # one point in, a 1 x n Gram out
    assert kernel.gram(t(x1[0]), t(x2)).shape == (1, 4)


# ---- MMD ----

@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("pair", range(len(KERNELS)))
def test_squared_mmd_equals_jax(biased, pair):
    kernel, jkernel = KERNELS[pair]
    x1, x2 = RNG.normal(size=(50, 2)), RNG.normal(size=(60, 2)) + 0.3
    got = st.squared_mmd(t(x1), t(x2), kernel, biased=biased).item()
    want = float(jst.squared_mmd(jnp.asarray(x1), jnp.asarray(x2), jkernel, biased=biased))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_mmd_separates_distributions():
    kernel = IsoSEKernel()
    x1, x2 = RNG.normal(size=(200, 2)), RNG.normal(size=(200, 2))
    x3 = RNG.normal(size=(200, 2)) + 5.0
    near, far = st.mmd(t(x1), t(x2), kernel).item(), st.mmd(t(x1), t(x3), kernel).item()
    assert near < 0.15 and far > 5 * near
    np.testing.assert_allclose(near, float(jst.mmd(jnp.asarray(x1), jnp.asarray(x2),
                                                   JIsoSEKernel())), rtol=1e-10)
    b = st.squared_mmd(t(x1[:50]), t(x2[:60]), kernel, biased=True).item()
    u = st.squared_mmd(t(x1[:50]), t(x2[:60]), kernel, biased=False).item()
    assert abs(b - u) < 0.1


# ---- index draws ----

@pytest.mark.parametrize("n,exclude", [(6, [1, 4]), (5, [0]), (7, [6, 0, 3]), (3, [])])
def test_choose_from_subset_never_lands_on_an_excluded_index(n, exclude):
    """2000 draws: none excluded, each allowed index about equally often
    (within 5 binomial standard deviations of 2000 / allowed)."""
    gen = torch.Generator().manual_seed(n)
    picks = np.array([int(st.choose_from_subset(gen, n, exclude)) for _ in range(2000)])
    allowed = [i for i in range(n) if i not in exclude]
    assert set(picks) == set(allowed)
    p = 1.0 / len(allowed)
    counts = np.bincount(picks, minlength=n)[allowed]
    assert np.all(np.abs(counts - 2000 * p) < 5 * np.sqrt(2000 * p * (1 - p)) + 1e-9)


def test_choose_is_uniform_and_reproducible():
    picks = [int(st.choose(torch.Generator().manual_seed(9), 10)) for _ in range(3)]
    assert len(set(picks)) == 1
    gen = torch.Generator().manual_seed(1)
    draws = torch.stack([st.choose(gen, 4) for _ in range(4000)])
    assert draws.dtype == torch.int64 and draws.shape == (4000,)
    counts = np.bincount(draws.numpy(), minlength=4)
    assert np.all(np.abs(counts - 1000) < 5 * np.sqrt(4000 * 0.25 * 0.75))
