"""Port parity, statistics and chains: ``cov``, ``mc_cov`` (both the direct
and the FFT lag paths of the vectorised INSE), ``multi_ess``, ``multi_rhat``,
``is_pos_def`` and ``nearest_pd`` against ``eeyore_tpu.stats`` /
``eeyore_tpu.linalg`` in float64 (1e-10), on AR(1) chains made with numpy;
and ``ChainLists`` / ``ChainList`` against the JAX package's on the same
arrays."""

import importlib

import numpy as np
import pytest
import torch

import eeyore_tpu.linalg as jlinalg
import eeyore_tpu.stats as jst
from eeyore_tpu.chains import ChainList as JChainList
from eeyore_tpu.chains import ChainLists as JChainLists
import eeyore_tpu_torch.linalg as tlinalg
import eeyore_tpu_torch.stats as tst
from eeyore_tpu_torch.chains import ChainList, ChainLists

F64_TOL = dict(rtol=1e-10, atol=1e-10)


def ar1(n, p, rho, seed):
    """An AR(1) chain x[t] = rho x[t-1] + noise with correlated noise, [n, p]."""
    rng = np.random.default_rng(seed)
    mix = np.eye(p) + 0.3 * rng.normal(size=(p, p))
    x = np.zeros((n, p))
    for t in range(1, n):
        x[t] = rho * x[t - 1] + mix @ rng.normal(size=p)
    return x + rng.normal(size=p)


def close(got, want):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(), np.asarray(want), **F64_TOL)


@pytest.mark.parametrize("shape", [(200, 3), (50, 1), (1, 7)])
def test_cov_and_cor(shape):
    x = np.random.default_rng(1).normal(size=shape)
    close(tst.cov(torch.as_tensor(x)), jst.cov(x))
    close(tst.cov(torch.as_tensor(x.T), rowvar=True), jst.cov(x.T, rowvar=True))
    if shape[0] > 1 and shape[1] > 1:
        close(tst.cor(torch.as_tensor(x)), jst.cor(x))


@pytest.mark.parametrize("n,p,rho,adjust", [(600, 3, 0.5, False), (600, 3, 0.5, True),
                                            (2000, 4, 0.9, False), (8192, 2, 0.995, False),
                                            (8192, 2, 0.995, True)])
def test_inse_mc_cov_matches_jax(n, p, rho, adjust):
    """The long, strongly correlated chains run the stopping rule past 48
    pair-lags and take the FFT lag path in both packages."""
    x = ar1(n, p, rho, seed=n + p)
    close(tst.mc_cov(torch.as_tensor(x), adjust=adjust), jst.mc_cov(x, adjust=adjust))
    close(tst.mc_se(torch.as_tensor(x)), jst.mc_se(x))
    close(tst.mc_cov(torch.as_tensor(x), method="iid"), jst.mc_cov(x, method="iid"))


def test_fft_path_is_taken_and_agrees_with_the_direct_path():
    tmc = importlib.import_module("eeyore_tpu_torch.stats.mc_cov")
    x = torch.as_tensor(ar1(8192, 2, 0.995, seed=3))
    provider = tmc._GammaProvider(x - x.mean(0))
    fft = provider._fft_gammas(100)
    direct = torch.stack([provider.gamma(m) for m in range(40)])
    torch.testing.assert_close(fft[:40] + fft[:40].transpose(1, 2),
                               direct + direct.transpose(1, 2), rtol=1e-9, atol=1e-12)
    provider.gamma(200)
    assert provider._fft_all is not None


def test_mc_cov_errors():
    with pytest.raises(RuntimeError, match="Not enough samples"):
        tst.mc_cov(torch.as_tensor(ar1(6, 5, 0.99, seed=0)))
    with pytest.raises(ValueError, match="inse or iid"):
        tst.mc_cov(torch.zeros(10, 2), method="nope")


@pytest.mark.parametrize("rho", [0.3, 0.95])
def test_multi_ess_matches_jax(rho):
    x = ar1(3000, 3, rho, seed=7)
    assert tst.multi_ess(torch.as_tensor(x)) == pytest.approx(jst.multi_ess(x), rel=1e-10)
    m = jst.mc_cov(x)
    assert tst.multi_ess(torch.as_tensor(x), mc_cov_mat=torch.as_tensor(m)) == pytest.approx(
        jst.multi_ess(x, mc_cov_mat=m), rel=1e-10)


@pytest.mark.parametrize("p", [2, 3])
def test_multi_rhat_matches_jax(p):
    draws = np.stack([ar1(800, p, 0.6, seed=s) for s in range(4)])
    got = tst.multi_rhat(torch.as_tensor(draws))
    want = jst.multi_rhat(draws)
    assert got[0] == pytest.approx(want[0], rel=1e-10)
    assert got[1] == pytest.approx(want[1], abs=1e-10)
    close(got[2], want[2])
    close(got[3], want[3])
    assert got[4:] == want[4:]


def test_pd_helpers_match_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(5, 5))
    spd = a @ a.T + 5 * np.eye(5)
    indefinite = (a + a.T) / 2
    for mat in (spd, indefinite, np.array([[1.0, 2.0], [0.0, 1.0]])):
        assert tlinalg.is_pos_def(torch.as_tensor(mat)) == jlinalg.is_pos_def(mat)
    close(tlinalg.nearest_pd(torch.as_tensor(indefinite)), jlinalg.nearest_pd(indefinite))
    close(tlinalg.nearest_pd(torch.as_tensor(spd)), jlinalg.nearest_pd(spd))
    singular = np.ones((3, 3))
    close(tlinalg.nearest_pd(torch.as_tensor(singular)), jlinalg.nearest_pd(singular))
    assert tlinalg.is_pos_def(tlinalg.nearest_pd(torch.as_tensor(singular)))


def test_chain_lists_match_jax():
    C, n, p = 4, 500, 3
    samples = np.stack([ar1(n, p, 0.5, seed=10 + c) for c in range(C)])
    accepted = (np.random.default_rng(2).uniform(size=(C, n)) < 0.7).astype(np.int32)
    arrays = {"sample": samples, "accepted": accepted}
    j = JChainLists.from_arrays(arrays)
    t = ChainLists.from_arrays({k: torch.as_tensor(v) for k, v in arrays.items()})
    assert (t.num_chains(), t.num_samples(), t.num_params()) == (C, n, p)
    assert repr(t) == repr(j)
    close(t.mean(), j.mean())
    close(t.mc_cov(), j.mc_cov())
    close(t.mc_se(), j.mc_se())
    np.testing.assert_allclose(t.acceptance(), j.acceptance(), **F64_TOL)
    np.testing.assert_allclose(t.multi_ess(), j.multi_ess(), **F64_TOL)
    assert t.multi_rhat()[0] == pytest.approx(j.multi_rhat()[0], rel=1e-10)
    keys = ("mean", "mc_se", "acceptance", "multi_ess", "multi_rhat")
    got, want = t.summary(keys=keys), j.summary(keys=keys)
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), **F64_TOL)


def test_chain_list_matches_jax():
    x = ar1(700, 2, 0.7, seed=4)
    acc = (np.arange(700) % 3 != 0).astype(np.int32)
    j = JChainList.from_arrays({"sample": x, "accepted": acc})
    t = ChainList.from_arrays({"sample": torch.as_tensor(x), "accepted": torch.as_tensor(acc)})
    assert len(t) == len(j) == 700 and t.num_params() == 2
    close(t.mean(), j.mean())
    close(t.mc_cov(), j.mc_cov())
    assert t.multi_ess() == pytest.approx(j.multi_ess(), rel=1e-10)
    assert t.acceptance_rate() == pytest.approx(j.acceptance_rate(), rel=1e-12)
    streamed = ChainList(keys=("sample", "accepted"))
    for row, a in zip(x[:5], acc[:5]):
        streamed.detach_and_update({"sample": torch.as_tensor(row), "accepted": int(a)})
    close(streamed.get_samples(), x[:5])
    assert len(streamed) == 5
