"""Port, the models' summaries and the posterior predictive
(``models/model.py::summary``, ``hashsummary``,
``BayesianModel.predictive_posterior{,_from_dataset}``,
``integrators/mc.py``), and the rest of the datasets (``DataCounter``,
``XYIDataset``, ``IDataset``, ``EmptyXYDataset``, banknotes), against the
JAX package's on the same numpy inputs: the cases of tests/test_models.py
and tests/test_datasets.py, and the port against JAX in float64 to 1e-10."""

import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.datasets import DataCounter as JDataCounter
from eeyore_tpu.datasets import XYDataset as JXYDataset
from eeyore_tpu.integrators import MCIntegrator as JMCIntegrator
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import LogisticRegression as JLogisticRegression
from eeyore_tpu.models import logistic_regression as jlr
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu_torch.datasets import (
    DataCounter,
    EmptyXYDataset,
    IDataset,
    XYDataset,
    XYIDataset,
    data_paths,
)
from eeyore_tpu_torch.integrators import Integrator, MCIntegrator
from eeyore_tpu_torch.models import MLP, LogisticRegression, logistic_regression, loss_functions
from eeyore_tpu_torch.models import mlp

RNG = np.random.default_rng(16)
XOR = (np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]]), np.array([[0.], [1.], [1.], [0.]]))


def xor_pair(dtype=torch.float64):
    return (MLP(loss_functions["binary_classification"], device="cpu", dtype=dtype,
                hparams=mlp.Hyperparameters(dims=[2, 2, 1])),
            JMLP(jloss_functions["binary_classification"],
                 hparams=jmlp.Hyperparameters(dims=[2, 2, 1])))


def lr_pair(dtype=torch.float64):
    return (LogisticRegression(loss_functions["binary_classification"], device="cpu",
                               dtype=dtype, hparams=logistic_regression.Hyperparameters(6, 1)),
            JLogisticRegression(jloss_functions["binary_classification"],
                                hparams=jlr.Hyperparameters(6, 1)))


def banknotes():
    ds = XYDataset.from_eeyore("banknotes")
    return XYDataset((ds.x - ds.x.mean(axis=0)) / ds.x.std(axis=0), ds.y)


# ---- summary and hashsummary ----

@pytest.mark.parametrize("pair", [xor_pair, lr_pair])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_hashsummary_equals_jax(pair, dtype):
    """The same sha256 digests as JAX's for the same theta: one per
    parameter group of an MLP, one for an LR (no ``unpack``)."""
    model, jmodel = pair()
    theta = RNG.normal(size=model.num_params).astype(dtype)
    got = model.hashsummary(torch.as_tensor(theta))
    want = jmodel.hashsummary(theta)
    assert got == want
    assert len(got) == (4 if pair is xor_pair else 1)


def test_summary_prints_what_jax_prints_but_the_names():
    for pair in (xor_pair, lr_pair):
        model, jmodel = pair()
        theta = RNG.normal(size=model.num_params)
        out, jout = io.StringIO(), io.StringIO()
        with redirect_stdout(out):
            model.summary(torch.as_tensor(theta), hashsummary=True)
        with redirect_stdout(jout):
            jmodel.summary(theta, hashsummary=True)
        lines, jlines = out.getvalue().splitlines(), jout.getvalue().splitlines()
        assert len(lines) == len(jlines)
        assert f"Number of model parameters: {model.num_params}" in lines
        tail = lines.index("Hash Summary:")
        assert lines[tail:] == jlines[jlines.index("Hash Summary:"):]
        out = io.StringIO()
        with redirect_stdout(out):
            model.summary()
        assert "Hash Summary:" not in out.getvalue()


# ---- the integrator and the posterior predictive ----

def test_integrator_running_mean_equivalence():
    """tests/test_datasets.py: NaN integrands dropped and counted."""
    assert issubclass(MCIntegrator, Integrator)
    vals = torch.tensor([1.0, 2.0, 3.0, float("nan"), 4.0], dtype=torch.float64)
    integral, dropped = MCIntegrator(f=lambda s, x, y: s[:, 0], samples=vals[:, None]).integrate(
        None, None)
    assert dropped == 1
    assert integral.item() == 2.5
    integral, dropped = MCIntegrator(f=lambda s, x, y: s[:, 0] * float("nan"),
                                     samples=vals[:, None]).integrate(None, None)
    assert dropped == 5 and integral.item() == 0.0


def test_integrate_from_dataset_without_shuffle_equals_jax():
    """Cycling past the end (numpy's resize), indices and integrals equal
    JAX's."""
    x = np.arange(10).reshape(5, 2).astype(float)
    ds = XYIDataset(x, np.zeros((5, 1)))
    samples = RNG.normal(size=(3, 1))
    got = MCIntegrator(f=lambda s, xx, yy: xx.sum() + s[:, 0], samples=torch.as_tensor(
        samples)).integrate_from_dataset(ds, num_points=7, shuffle=False)
    want = JMCIntegrator(f=lambda s, xx, yy: jnp.sum(xx) + s[0], samples=jnp.asarray(
        samples)).integrate_from_dataset(ds, num_points=7, shuffle=False)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], [0, 1, 2, 3, 4, 0, 1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_array_equal(got[2], want[2])


def test_integrate_from_dataset_shuffles_by_the_generator():
    ds = XYIDataset(np.arange(20).reshape(10, 2).astype(float), np.zeros((10, 1)))
    integ = MCIntegrator(f=lambda s, xx, yy: xx[:, 0].sum() + 0 * s[:, 0],
                         samples=torch.zeros((2, 1), dtype=torch.float64))
    a = integ.integrate_from_dataset(ds, 10, generator=torch.Generator().manual_seed(3))
    b = integ.integrate_from_dataset(ds, 10, generator=torch.Generator().manual_seed(3))
    c = integ.integrate_from_dataset(ds, 10)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(np.sort(a[1]), np.arange(10))
    np.testing.assert_array_equal(a[0], 2 * a[1])  # x[j, 0] = 2 j
    np.testing.assert_array_equal(np.sort(c[1]), np.arange(10))


@pytest.mark.parametrize("pair", [xor_pair, lr_pair])
def test_predictive_posterior_equals_jax_with_nan_dropping(pair):
    """tests/test_models.py's case on XOR, and LR on banknotes: the integral
    equals JAX's in f64 to 1e-10; one NaN sample is dropped."""
    model, jmodel = pair()
    x, y = XOR if pair is xor_pair else (banknotes().x, banknotes().y)
    thetas = RNG.normal(size=(20, model.num_params))
    for j in (0, 1):
        got, dropped = model.predictive_posterior(torch.as_tensor(thetas), x[j:j + 1],
                                                  y[j:j + 1])
        want, jdropped = jmodel.predictive_posterior(jnp.asarray(thetas), jnp.asarray(x[j:j + 1]),
                                                     jnp.asarray(y[j:j + 1]))
        assert dropped == jdropped == 0
        assert 0.0 <= got.item() <= 1.0
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-10)
    bad = thetas.copy()
    bad[3, 0] = np.nan
    got, dropped = model.predictive_posterior(torch.as_tensor(bad), x[:1], y[:1])
    want, jdropped = jmodel.predictive_posterior(jnp.asarray(bad), jnp.asarray(x[:1]),
                                                 jnp.asarray(y[:1]))
    assert dropped == jdropped == 1
    assert not np.isnan(got.item())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-10)


def test_predictive_posterior_from_dataset_equals_jax():
    """LR on the 200 standardised banknotes, ``shuffle=False``: integrals,
    indices and drops equal JAX's; the posterior-mean accuracy of samples
    near a fitted separator is high."""
    model, jmodel = lr_pair()
    ds = banknotes()
    w = np.linalg.lstsq(np.c_[ds.x, np.ones(200)], 2 * ds.y[:, 0] - 1, rcond=None)[0]
    thetas = 4 * w + 0.3 * RNG.normal(size=(16, 7))
    got = model.predictive_posterior_from_dataset(torch.as_tensor(thetas), ds, 200,
                                                  shuffle=False)
    want = jmodel.predictive_posterior_from_dataset(jnp.asarray(thetas), ds, 200, shuffle=False)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert np.mean(got[0] > 0.5) > 0.9


# ---- the datasets ----

def test_bundled_data_equal_jax():
    assert set(data_paths) == {"xor", "iris", "banknotes"}
    for name, kw in (("xor", {}), ("iris", {"yonehot": True}), ("banknotes", {})):
        ds, jds = XYDataset.from_eeyore(name, **kw), JXYDataset.from_eeyore(name, **kw)
        np.testing.assert_array_equal(ds.x, jds.x)
        np.testing.assert_array_equal(ds.y, jds.y)
    ds = XYDataset.from_eeyore("banknotes")
    assert ds.x.shape == (200, 6) and ds.y.shape == (200, 1)
    assert set(np.unique(ds.y)) == {0.0, 1.0}
    with pytest.raises(ValueError, match="banknotes"):
        XYDataset.from_eeyore("nope")


def test_indexed_and_empty_datasets():
    ds = XYIDataset(np.arange(10).reshape(5, 2), np.zeros((5, 1)))
    x3, _, idx = ds[3]
    assert idx == 3 and list(x3) == [6, 7] and repr(ds) == "XYIDataset: indexed XYDataset"
    again = XYIDataset.from_xydataset(XYDataset.from_eeyore("xor"))
    assert len(again) == 4 and again[2][2] == 2
    wrapped = IDataset(XYDataset.from_eeyore("xor"))
    x, y, idx = wrapped[1]
    assert len(wrapped) == 4 and idx == 1 and list(x) == [0, 1] and y[0] == 1
    assert wrapped.x.shape == (4, 2) and wrapped.y.shape == (4, 1)
    empty = EmptyXYDataset()
    assert len(empty) == 1 and empty.x.shape == (1, 0) and empty.y.shape == (1, 0)
    assert repr(empty) == "Empty XYDataset"


@pytest.mark.parametrize("batch_size,sample_size,drop_last", [(10, 35, False), (10, 35, True),
                                                             (7, 7, False), (3, 200, False)])
def test_data_counter_equals_jax(batch_size, sample_size, drop_last):
    c = DataCounter(batch_size, sample_size, drop_last=drop_last)
    j = JDataCounter(batch_size, sample_size, drop_last=drop_last)
    assert c.num_batches == j.num_batches
    for setter, args in (("set_epoch_info", (100, 10)), ("set_iter_info", (401, 41)),
                         ("set_epoch_info", (None, 3))):
        getattr(c, setter)(*args)
        getattr(j, setter)(*args)
        assert vars(c) == vars(j)
    c.increment_idx()
    c.increment_idx(3)
    assert c.idx == 4
    c.reset()
    assert c.idx == 0
    ds = XYDataset.from_eeyore("banknotes")
    assert vars(DataCounter.from_dataset(ds, 64, 5, 2)) == vars(JDataCounter.from_dataset(
        ds, 64, 5, 2))
    assert DataCounter(10, 35).num_batches == 4 and DataCounter(10, 35, drop_last=True) \
        .num_batches == 3
