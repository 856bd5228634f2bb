"""Port, the experiment harness: ``samplers/harness.py::SamplerHarness``
against the JAX package's. The thirteen cases of tests/test_harness.py in
the port's terms (epoch accounting, the prior init, ``reset``, the
benchmark's quota, layout, conditions, amortised runtime, given inits,
retries and the init list's indexing, the verbose runner, the minibatch
step search and the schedule's wiring); the directory tree and the bytes of
``run_counts.txt`` (and of the error files) that a benchmark writes equal
JAX's for the same outcome of the quota, the conditions and the non-finite
chains; the verbose run's chain equal to the silent generic run's for the
same generator state; and the errors of a kernel's build or launch, and
CUDA errors, propagating out of ``benchmark`` where a numerical
``RuntimeError`` is written to ``errors/``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.samplers import MALA as JMALA
from eeyore_tpu.samplers import SamplerHarness as JSamplerHarness
from eeyore_tpu_torch.datasets import BatchSchedule
from eeyore_tpu_torch.models import MLP, DistributionModel, loss_functions, mlp
from eeyore_tpu_torch.ops import _build
from eeyore_tpu_torch.ops.resident_hmc import raise_on
from eeyore_tpu_torch.samplers import HMC, MALA, MetropolisHastings, SamplerHarness
from eeyore_tpu_torch.samplers import harness as harness_module
from eeyore_tpu_torch.tuners.dual_averaging import HMCDATuner

F64 = dict(dtype=torch.float64, device="cpu")
EMPTY = (torch.zeros((1, 0), dtype=torch.float64), torch.zeros((1, 0), dtype=torch.float64))
XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])


def gen(seed):
    return torch.Generator().manual_seed(seed)


def bvn_model():
    prec = torch.as_tensor(np.linalg.inv(np.array([[1.0, 0.5], [0.5, 1.0]])))
    return DistributionModel(lambda t, x, y: -0.5 * ((t @ prec) * t).sum(-1), num_params=2,
                             **F64)


def xor_mlp():
    model = MLP(loss=loss_functions["binary_classification"],
                hparams=mlp.Hyperparameters(dims=[2, 2, 1]), **F64)
    return model, (torch.as_tensor(XOR_X), torch.as_tensor(XOR_Y))


# ---- tests/test_harness.py, in the port's terms ----

class TestRun:
    def test_epoch_accounting(self):
        h = SamplerHarness(MALA(bvn_model(), step=0.4), EMPTY,
                           theta0=torch.tensor([1.0, 1.0]), generator=gen(0))
        chain = h.run(num_epochs=1000, num_burnin_epochs=200)
        assert len(chain) == 800
        assert 0.3 < chain.acceptance_rate() < 1.0
        assert h.counter.num_iters == 1000

    def test_default_theta0_samples_prior(self):
        model, data = xor_mlp()
        h = SamplerHarness(MALA(model, step=0.01), data)
        chain = h.run(num_epochs=50, num_burnin_epochs=10)
        assert len(chain) == 40
        assert h.theta0.shape == (model.num_params,)

    def test_reset(self):
        h = SamplerHarness(MetropolisHastings(bvn_model(), scale=0.5), EMPTY,
                           theta0=torch.zeros(2))
        h.run(100, 10)
        h.reset(torch.tensor([5.0, 5.0]))
        assert len(h.chain) == 0
        assert len(h.run(100, 10)) == 90


class TestBenchmark:
    def test_quota_and_layout(self, tmp_path):
        model, data = xor_mlp()
        h = SamplerHarness(MALA(model, step=0.05), data, generator=gen(1))
        accepted = h.benchmark(num_chains=3, num_epochs=200, num_burnin_epochs=50,
                               path=tmp_path, batch_chains=3)
        assert len(accepted) == 3
        for i in (1, 2, 3):
            assert (tmp_path / f"run{i}" / "sample.csv").exists()
            assert (tmp_path / f"run{i}" / "runtime.txt").exists()
        assert (tmp_path / "run_counts.txt").read_text().splitlines()[0] == "3,succesful"

    def test_conditions_filter(self, tmp_path):
        model, data = xor_mlp()
        h = SamplerHarness(MALA(model, step=0.05), data, generator=gen(2))
        accepted = h.benchmark(num_chains=2, num_epochs=50, num_burnin_epochs=10,
                               path=tmp_path, batch_chains=2, max_attempts=2,
                               check_conditions=lambda chain, rt: chain.acceptance_rate() > 2)
        assert accepted == []
        counts = (tmp_path / "run_counts.txt").read_text().splitlines()
        assert counts[:2] == ["0,succesful", "4,unmet_conditions"]

    def test_runtime_is_batch_amortized_per_chain(self, tmp_path):
        model, data = xor_mlp()
        h = SamplerHarness(MALA(model, step=0.05), data, generator=gen(5))
        seen = []

        def conds(chain, runtime):
            seen.append(runtime)
            return True

        h.benchmark(num_chains=4, num_epochs=50, num_burnin_epochs=10, path=tmp_path,
                    batch_chains=4, check_conditions=conds)
        assert len(seen) == 4 and all(rt == seen[0] for rt in seen)
        assert float((tmp_path / "run1" / "runtime.txt").read_text()) == seen[0]

    def test_given_inits(self, tmp_path):
        model, data = xor_mlp()
        h = SamplerHarness(MALA(model, step=0.05), data, generator=gen(3))
        init = [torch.zeros(model.num_params), torch.ones(model.num_params) * 0.1]
        accepted = h.benchmark(num_chains=2, num_epochs=50, num_burnin_epochs=10,
                               path=tmp_path, init=init, batch_chains=2)
        assert len(accepted) == 2


class TestVerboseRun:
    def test_verbose_segments_match_silent_run(self, capsys):
        h1 = SamplerHarness(MALA(bvn_model(), step=0.4), EMPTY,
                            theta0=torch.tensor([1.0, 1.0]), generator=gen(5))
        silent = h1.run(num_epochs=300, num_burnin_epochs=100)
        h2 = SamplerHarness(MALA(bvn_model(), step=0.4), EMPTY,
                            theta0=torch.tensor([1.0, 1.0]), generator=gen(5))
        loud = h2.run(num_epochs=300, num_burnin_epochs=100, verbose=True, verbose_step=64)
        assert torch.equal(loud.get_samples(), silent.get_samples())
        out = capsys.readouterr().out
        assert out.count("Iteration ") == 2 + 4  # ceil(100/64) + ceil(200/64) segments
        assert "Iteration 300/300" in out

    def test_verbose_with_thinning(self):
        h = SamplerHarness(MALA(bvn_model(), step=0.4), EMPTY,
                           theta0=torch.tensor([0.5, -0.5]), generator=gen(6))
        loud = h.run(num_epochs=260, num_burnin_epochs=100, verbose=True, verbose_step=50,
                     record_thin=4)
        assert len(loud) == 40
        h2 = SamplerHarness(MALA(bvn_model(), step=0.4), EMPTY,
                            theta0=torch.tensor([0.5, -0.5]), generator=gen(6))
        silent = h2.run(num_epochs=260, num_burnin_epochs=100, record_thin=4)
        assert torch.equal(loud.get_samples(), silent.get_samples())


class TestBenchmarkRetrySemantics:
    def test_retries_until_quota_default_unbounded(self, tmp_path):
        model, data = xor_mlp()
        h = SamplerHarness(MALA(model, step=0.05), data, generator=gen(7))
        seen = {"n": 0}

        def flaky(chain, runtime):
            seen["n"] += 1
            return seen["n"] > 2

        accepted = h.benchmark(num_chains=2, num_epochs=50, num_burnin_epochs=10,
                               path=tmp_path, batch_chains=1, check_conditions=flaky)
        assert len(accepted) == 2
        counts = (tmp_path / "run_counts.txt").read_text().splitlines()
        assert counts[:2] == ["2,succesful", "2,unmet_conditions"]

    def test_init_list_consumed_past_first_batch(self, tmp_path):
        model, data = xor_mlp()
        h = SamplerHarness(MALA(model, step=1e-8), data, generator=gen(8))
        init = [torch.full((model.num_params,), v, dtype=torch.float64) for v in (0.0, 0.3, -0.3)]
        accepted = h.benchmark(num_chains=3, num_epochs=20, num_burnin_epochs=0,
                               path=tmp_path, init=init, batch_chains=1)
        assert len(accepted) == 3
        for chain, want in zip(accepted, init):
            np.testing.assert_allclose(chain.get_samples()[0].numpy(), want.numpy(), atol=2e-3)


class TestInitStepBatchCycling:
    def test_minibatch_schedule_cycles(self):
        model, (x, y) = xor_mlp()
        kernel = HMC(model, step=0.1, num_steps=4, tuner=HMCDATuner(l=0.4))
        theta = 0.1 * torch.ones(1, model.num_params, dtype=torch.float64)
        momenta = torch.randn(theta.shape, generator=gen(9), dtype=torch.float64)
        full = BatchSchedule.full_batch(x, y)
        s_plain = kernel.find_initial_step(theta, x, y, momenta=momenta)
        s_full = kernel.find_initial_step(theta, x, y, momenta=momenta, schedule=full)
        torch.testing.assert_close(s_full, s_plain)
        mini = BatchSchedule(x.reshape(2, 2, 2), y.reshape(2, 2, 1))
        s_mini = kernel.find_initial_step(theta, x, y, momenta=momenta, schedule=mini)
        assert bool(torch.isfinite(s_mini).all()) and bool((s_mini > 0).all())

    def test_harness_run_wires_schedule(self):
        model, data = xor_mlp()
        h = SamplerHarness(HMC(model, step=0.1, num_steps=4, tuner=HMCDATuner(l=0.4)),
                           data=data, theta0=0.1 * torch.ones(model.num_params),
                           generator=gen(10))
        assert len(h.run(num_epochs=40, num_burnin_epochs=20)) == 20
        assert getattr(h.kernel, "init_schedule", None) is not None


# ---- the tree a benchmark writes, against JAX's ----

def tree(path):
    return sorted(str(p.relative_to(path)) for p in path.rglob("*"))


def jax_xor():
    return JMLP(loss=jloss_functions["binary_classification"],
                hparams=jmlp.Hyperparameters(dims=[2, 2, 1]))


def flaky_after(n):
    seen = {"n": 0}

    def check(chain, runtime):
        seen["n"] += 1
        return seen["n"] > n
    return check


@pytest.mark.parametrize("num_chains,batch_chains,rejected,nan_init,max_attempts", [
    (10, 10, 0, False, None),  # run01 ... run10
    (2, 2, 1, True, 3),        # errors/, unmet conditions, prior draws past the list
    (3, 2, 2, False, None),    # retries to the quota
], ids=["zfill", "errors", "retries"])
def test_benchmark_tree_equals_jax(tmp_path, num_chains, batch_chains, rejected, nan_init,
                                   max_attempts):
    model, data = xor_mlp()
    jmodel = jax_xor()
    init = [np.full(model.num_params, np.nan)] if nan_init else None
    kw = dict(num_chains=num_chains, num_epochs=30, num_burnin_epochs=10,
              batch_chains=batch_chains, max_attempts=max_attempts)
    port = SamplerHarness(MALA(model, step=0.05), data, generator=gen(11))
    port.benchmark(path=tmp_path / "port", check_conditions=flaky_after(rejected),
                   init=None if init is None else [torch.as_tensor(v) for v in init], **kw)
    ref = JSamplerHarness(JMALA(jmodel, step=0.05), (jnp.asarray(XOR_X), jnp.asarray(XOR_Y)),
                          key=jax.random.PRNGKey(11))
    ref.benchmark(path=tmp_path / "jax", check_conditions=flaky_after(rejected),
                  init=None if init is None else [jnp.asarray(v) for v in init], **kw)
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    for name in ["run_counts.txt"] + [p for p in tree(tmp_path / "jax") if p.startswith("errors/")]:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    if nan_init:
        assert (tmp_path / "port" / "run_counts.txt").read_text() == \
            "2,succesful\n1,unmet_conditions\n2,runtime_errors\n"


# ---- what benchmark catches, and what it lets through ----

def raising(err):
    def sample_chains(*args, **kwargs):
        raise err
    return sample_chains


ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)


@pytest.mark.parametrize("err", [
    _build.KernelError("building resident_hmc.cu as resident_hmc_x failed"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
] + ([ACCELERATOR_ERROR("CUDA error: unspecified launch failure")] if ACCELERATOR_ERROR else []),
    ids=lambda e: type(e).__name__)
def test_kernel_and_cuda_errors_propagate(tmp_path, monkeypatch, err):
    model, data = xor_mlp()
    monkeypatch.setattr(harness_module, "sample_chains", raising(err))
    h = SamplerHarness(MALA(model, step=0.05), data, generator=gen(12))
    with pytest.raises(type(err)):
        h.benchmark(num_chains=2, num_epochs=10, num_burnin_epochs=0, path=tmp_path)
    assert not (tmp_path / "errors").exists()


@pytest.mark.parametrize("err", [
    RuntimeError("linalg.cholesky: The factorization could not be completed"),
    FloatingPointError("invalid value encountered"),
], ids=lambda e: type(e).__name__)
def test_numerical_errors_go_to_errors(tmp_path, monkeypatch, err):
    model, data = xor_mlp()
    monkeypatch.setattr(harness_module, "sample_chains", raising(err))
    h = SamplerHarness(MALA(model, step=0.05), data, generator=gen(13))
    assert h.benchmark(num_chains=2, num_epochs=10, num_burnin_epochs=0, path=tmp_path,
                       batch_chains=2, max_attempts=2) == []
    assert (tmp_path / "errors" / "error4.txt").read_text() == f"{err}\n"
    assert (tmp_path / "run_counts.txt").read_text() == \
        "0,succesful\n0,unmet_conditions\n4,runtime_errors\n"


def test_build_and_launch_failures_raise_kernel_errors(monkeypatch):
    """A failed build and a library's CUDA error code raise ``KernelError``."""
    import torch.utils.cpp_extension as cpp_extension

    def failing_load(**kwargs):
        raise RuntimeError("Error building extension 'resident_hmc'")

    monkeypatch.setattr(cpp_extension, "load", failing_load)
    with pytest.raises(_build.KernelError, match="resident_hmc.cu"):
        _build.load_library("resident_hmc_harness_probe", "resident_hmc.cu")
    with pytest.raises(_build.KernelError, match="launch failed: boom"):
        raise_on(700, lambda err: b"boom", "resident_hmc launch failed")
    assert harness_module.is_kernel_or_device_error(_build.KernelError("x"))
    assert not harness_module.is_kernel_or_device_error(RuntimeError("Not enough samples"))
