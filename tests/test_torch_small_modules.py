"""Port, the small modules: ``datasets/mld_batcher.py`` (the same rows as
JAX's ``MLDClassificationBatcher`` for the same seed and parameters, the
set-up of tests/test_datasets.py:110-130), ``plots.py`` (the line, bar and
stem data of each plot equal JAX's for the same draws, given as tensors;
tests/test_plots.py's four cases under Agg), ``utils/profiling.py``
(``PhaseTimer``, ``timed``, ``device_trace`` on the CPU),
``utils/dtypes.py::default_float``, and ``ops/resident_smc.py::
run_smc_resident`` on the CPU (the plain mutation pass), equal to its
maker's runner for the same seed."""

import json

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from eeyore_tpu import plots as jplots
from eeyore_tpu.chains import ChainList as JChainList
from eeyore_tpu.datasets import MLDClassificationBatcher as JMLDClassificationBatcher
from eeyore_tpu.datasets import XYDataset as JXYDataset
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu_torch import plots
from eeyore_tpu_torch.chains import ChainList
from eeyore_tpu_torch.datasets import MLDBatcher, MLDClassificationBatcher, XYDataset
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops.resident_smc import make_resident_smc, run_smc_resident
from eeyore_tpu_torch.utils import PhaseTimer, default_float, device_trace, timed


def teardown_function(_fn):
    plt.close("all")


# ---- MLD batch selection ----

def mld_problem(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(60, 4))
    y = np.eye(3)[np.repeat([0, 1, 2], 20)]
    params = [rng.normal(size=27) for _ in range(2)]
    port = MLP(loss=loss_functions["multiclass_classification"], dtype=torch.float64,
               device="cpu", hparams=mlp.Hyperparameters(dims=[4, 3, 3],
                                                         activations=[mlp.sigmoid, None]))
    ref = JMLP(loss=jloss_functions["multiclass_classification"],
               hparams=jmlp.Hyperparameters(dims=[4, 3, 3], activations=[jmlp.sigmoid, None]))
    return x, y, params, port, ref


@pytest.mark.parametrize("seed,num_batches,chunks", [(0, 4, [9, 6]), (3, 16, [7, 5]),
                                                     (5, 8, [20, 11])])
def test_mld_batcher_picks_jaxs_rows(seed, num_batches, chunks):
    x, y, params, port, ref = mld_problem(seed)
    batcher = MLDClassificationBatcher(num_batches=num_batches, chunk_sizes=chunks,
                                       dataset=XYDataset(x, y), seed=seed)
    jbatcher = JMLDClassificationBatcher(num_batches=num_batches, chunk_sizes=chunks,
                                         dataset=JXYDataset(x, y), seed=seed)
    assert isinstance(batcher, MLDBatcher) and batcher.batch_size() == sum(chunks)
    for _ in range(3):  # the batchers' generators advance alike
        xb, yb = batcher.get_batch(port, [torch.as_tensor(p) for p in params])
        jxb, jyb = jbatcher.get_batch(ref, params)
        np.testing.assert_array_equal(xb, np.asarray(jxb))
        np.testing.assert_array_equal(yb, np.asarray(jyb))
    assert xb.shape == (sum(chunks), 4) and yb.shape == (sum(chunks), 3)
    assert yb.sum(axis=0).min() >= 3


# ---- plots ----

def draws(n, seed=17):
    return np.random.default_rng(seed).normal(size=n)


def lines(ax):
    return [np.asarray(line.get_ydata()) for line in ax.lines]


def test_trace_and_hist_equal_jax(tmp_path):
    d = draws(300)
    fig, ax = plots.trace(torch.as_tensor(d), title="t")
    _, jax_ax = jplots.trace(d, title="t")
    assert ax.get_title() == "t" and len(ax.lines) == 1
    np.testing.assert_array_equal(lines(ax)[0], lines(jax_ax)[0])
    fig.savefig(tmp_path / "trace.png")
    _, ax = plots.hist(torch.as_tensor(d), bins=10)
    _, jax_ax = jplots.hist(d, bins=10)
    assert len(ax.patches) == 10
    assert [p.get_height() for p in ax.patches] == [p.get_height() for p in jax_ax.patches]
    assert [p.get_x() for p in ax.patches] == [p.get_x() for p in jax_ax.patches]


def test_running_mean_equals_jax():
    _, ax = plots.running_mean(torch.tensor([1.0, 3.0, 5.0]))
    np.testing.assert_allclose(lines(ax)[0], [1.0, 2.0, 3.0])
    d = draws(200, seed=2)
    _, jax_ax = jplots.running_mean(d)
    _, ax = plots.running_mean(torch.as_tensor(d))
    np.testing.assert_array_equal(lines(ax)[0], lines(jax_ax)[0])


def test_acf_equals_jax():
    d = draws(500)
    _, ax = plots.acf(torch.as_tensor(d), max_lag=10)
    _, jax_ax = jplots.acf(d, max_lag=10)
    heads = ax.containers[0].markerline.get_ydata()
    np.testing.assert_allclose(heads[0], 1.0, atol=1e-12)
    np.testing.assert_array_equal(heads, jax_ax.containers[0].markerline.get_ydata())


def test_chain_summary_figure_equals_jax():
    rng = np.random.default_rng(17)
    cols = {"sample": rng.normal(size=(100, 3)), "target_val": rng.normal(size=100),
            "accepted": np.ones(100, dtype=int)}
    fig = plots.chain_summary_figure(
        ChainList.from_arrays({k: torch.as_tensor(v) for k, v in cols.items()}), params=[0, 2])
    jax_fig = jplots.chain_summary_figure(JChainList.from_arrays(cols), params=[0, 2])
    assert len(fig.axes) == len(jax_fig.axes) == 2 * 3
    for ax, jax_ax in zip(fig.axes, jax_fig.axes):
        for got, want in zip(lines(ax), lines(jax_ax)):
            np.testing.assert_array_equal(got, want)
        assert [p.get_height() for p in ax.patches] == [p.get_height() for p in jax_ax.patches]
        assert ax.get_ylabel() == jax_ax.get_ylabel()


# ---- profiling and dtypes ----

def test_phase_timer_and_timed():
    timer = PhaseTimer()
    with timer.phase("a"):
        pass
    with timer.phase("b"):
        out, seconds = timed(lambda v: torch.ones(v).sum(), 1000)
    with timer.phase("a"):
        pass
    assert out.item() == 1000.0 and seconds > 0
    report = timer.report()
    assert list(report) == ["b", "a"] and report["b"] >= seconds
    assert timed(lambda: 3, block=False)[0] == 3


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(tmp_path / "trace"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_default_float():
    assert default_float() == torch.get_default_dtype()
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        assert default_float() == torch.float64
    finally:
        torch.set_default_dtype(previous)


# ---- run_smc_resident ----

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]], dtype=np.float32)
XOR_Y = np.array([[0.], [1.], [1.], [0.]], dtype=np.float32)


@pytest.mark.parametrize("mutation,betas", [("MALA", None), ("MH", "adaptive")])
def test_run_smc_resident_equals_its_makers_runner(mutation, betas):
    model = MLP(loss=loss_functions["binary_classification"], device="cpu",
                hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
    kw = dict(num_particles=256, betas=betas, num_mutation_steps=2, mutation=mutation,
              mutation_step=0.05, chain_block=128)
    particles, log_w, diags = run_smc_resident(model, XOR_X, XOR_Y, seed=7, device="cpu", **kw)
    want = make_resident_smc(model, XOR_X, XOR_Y, device="cpu", **kw)(7)
    assert torch.equal(particles, want[0]) and torch.equal(log_w, want[1])
    assert diags["log_evidence"] == want[2]["log_evidence"]
    assert diags.keys() == want[2].keys()
    assert particles.shape == (256, model.num_params) and bool(torch.isfinite(particles).all())
