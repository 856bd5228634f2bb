"""Port, kernel-backend dispatch: the HMC, MH, MALA, Gibbs, tempering and
SMC cases of tests/test_dispatch.py rewritten for the port (``resolve_smc``
decides as the JAX package's, which the SMC cases call as their oracle), and the port's
faults of kernel eligibility, the step heuristic and the kernel cache, each
with its test. Plans are made for platform="cuda" on the CPU, as
the JAX tests plan for "tpu"; a plan run on CPU tensors goes through the
kernel's plain version, so ``sample_chains(backend="resident")`` is tested
here end to end into ``ChainLists`` (the CUDA kernel itself is held against
the plain version on the card by ``chip_smoke.py``)."""

import math

import numpy as np
import pytest
import torch

from eeyore_tpu_torch.datasets import BatchSchedule, XYDataset
from eeyore_tpu_torch.models import MLP, DistributionModel, IIDNormalPrior, loss_functions, mlp
from eeyore_tpu_torch.kernels import MultivariateNormalKernel, NormalKernel
from eeyore_tpu_torch.ops import resident_hmc, resident_hmc_dense, resident_walk
from eeyore_tpu_torch.ops import resident_walk_dense
from eeyore_tpu_torch.samplers import (
    HMC,
    MALA,
    Gibbs,
    MetropolisHastings,
    PowerPosteriorSampler,
    SMCSampler,
    TransitionKernel,
    sample_chain,
    sample_chains,
)
from eeyore_tpu_torch.samplers import dispatch
from eeyore_tpu_torch.samplers.dispatch import resolve_backend, resolve_tempering
from eeyore_tpu_torch.tuners import HMCDATuner

XOR = (np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]]), np.array([[0.], [1.], [1.], [0.]]))


def xor_model(dtype=torch.float32):
    return MLP(loss=loss_functions["binary_classification"], dtype=dtype, device="cpu",
               hparams=mlp.Hyperparameters(dims=[2, 2, 1]))


def iris_model():
    return MLP(loss=loss_functions["multiclass_classification"], dtype=torch.float32,
               device="cpu",
               hparams=mlp.Hyperparameters(dims=[4, 3, 3], activations=[mlp.sigmoid, None]))


def iris_data():
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    return ds.x, ds.y


def test_iris_resolves_resident_with_block_256():
    plan, reason = resolve_backend(HMC(iris_model(), step=0.02, num_steps=8), iris_data(),
                                   16384, 256, platform="cuda")
    assert plan is not None, reason
    assert plan.backend == "resident" and plan.maker.__name__ == "make_resident_hmc"
    assert plan.chain_block == 256


@pytest.mark.parametrize("chains,block", [(131072, 4096), (8192, 4096), (384, 128)])
def test_xor_resolves_resident_under_the_small_model_cap(chains, block):
    """Asked for the resident kernel (``auto`` sends XOR to the dense one,
    test_auto_sends_small_data_to_dense): JAX's small-model cap of 4096 (off
    the card nothing else caps the group)."""
    plan, reason = resolve_backend(HMC(xor_model(), step=0.05, num_steps=10), XOR, chains, 256,
                                   platform="cuda", backend="resident")
    assert plan is not None, reason
    assert plan.backend == "resident" and plan.chain_block == block
    assert plan.kwargs["step"] == 0.05 and plan.kwargs["num_steps"] == 10


def test_dense_raises_not_yet_ported():
    """The dense kernels are ported: an explicit ``backend="dense"`` now
    raises only where it is ineligible, as in the JAX package: iris has more
    than MAX_DENSE_ROWS rows, and the dense kernels take chains in multiples
    of 1024."""
    for kernel in (HMC(iris_model(), step=0.05), MetropolisHastings(iris_model(), scale=0.1),
                   MALA(iris_model(), step=0.003)):
        with pytest.raises(ValueError, match="MAX_DENSE_ROWS"):
            resolve_backend(kernel, iris_data(), 8192, 256, platform="cuda", backend="dense")
    with pytest.raises(ValueError, match="divisible by 1024"):
        resolve_backend(HMC(xor_model(), step=0.05), XOR, 1536, 256, platform="cuda",
                        backend="dense")
    plan, _ = resolve_backend(HMC(xor_model(), step=0.05), XOR, 8192, 256, platform="cuda",
                              backend="dense")
    assert plan.backend == "dense" and plan.chain_block == 8192


def test_tuner_and_rounding_are_forwarded():
    tuner = HMCDATuner(l=0.5)
    plan, _ = resolve_backend(HMC(xor_model(), tuner=tuner), XOR, 1024, 256, platform="cuda")
    assert plan.kwargs["tuner"] is tuner and plan.kwargs["l_rounding"] == "round"
    assert plan.kwargs["max_num_steps"] == 64  # the default ceiling takes the kernel cap
    plan, _ = resolve_backend(HMC(xor_model(), tuner=tuner, l_rounding="stochastic"), XOR,
                              1024, 256, platform="cuda")
    assert plan.kwargs["l_rounding"] == "stochastic"


@pytest.mark.parametrize("max_num_steps,eligible", [(128, False), (64, True), (16, True)])
def test_explicit_max_num_steps_above_the_cap_is_ineligible(max_num_steps, eligible):
    kernel = HMC(xor_model(), tuner=HMCDATuner(l=0.5), max_num_steps=max_num_steps)
    plan, reason = resolve_backend(kernel, XOR, 8192, 256, platform="cuda")
    if eligible:
        assert plan is not None and plan.kwargs["max_num_steps"] == max_num_steps
    else:
        assert plan is None and "64" in reason


def test_large_models_are_ineligible():
    wide = MLP(loss=loss_functions["multiclass_classification"], dtype=torch.float32,
               device="cpu",
               hparams=mlp.Hyperparameters(dims=[64, 8, 2], activations=[mlp.sigmoid, None]))
    assert wide.num_params > 256
    x = np.zeros((16, 64))
    y = np.zeros((16, 2))
    y[:, 0] = 1.0
    plan, reason = resolve_backend(HMC(wide, step=0.01), (x, y), 8192, 256, platform="cuda")
    assert plan is None and "MAX_DISPATCH_PARAMS" in reason


@pytest.mark.parametrize("keys,eligible,extras", [
    (("sample", "grad_val"), False, None), (("sample",), True, False),
    (("sample", "accepted"), True, False), (("sample", "target_val", "accepted"), True, True),
    (None, True, False)])
def test_record_key_contract(keys, eligible, extras):
    plan, reason = resolve_backend(HMC(xor_model(), step=0.05), XOR, 8192, 256,
                                   platform="cuda", record_keys=keys)
    if eligible:
        assert plan is not None and plan.kwargs["record_extras"] is extras
    else:
        assert plan is None and "grad_val" in reason


def test_explicit_backends_raise_when_ineligible():
    with pytest.raises(ValueError, match="ineligible"):
        resolve_backend(HMC(xor_model(), step=0.05), XOR, 8192, 256, platform="cpu",
                        backend="resident")
    with pytest.raises(ValueError, match="record_keys"):
        resolve_backend(HMC(xor_model(), step=0.05), XOR, 8192, 256, platform="cuda",
                        backend="resident", record_keys=("momentum",))
    with pytest.raises(ValueError, match="divisible by 128"):
        resolve_backend(HMC(xor_model(), step=0.05), XOR, 1000, 256, platform="cuda",
                        backend="resident")
    with pytest.raises(ValueError, match="backend"):
        resolve_backend(HMC(xor_model(), step=0.05), XOR, 8192, 256, backend="gpu")


def test_ineligible_configs_fall_back_under_auto():
    model = xor_model()
    plan, reason = resolve_backend(HMC(model, step=0.05), XOR, 1000, 256, platform="cuda")
    assert plan is None and "divisible" in reason
    plan, reason = resolve_backend(HMC(model, step=0.05), XOR, 8192, 256, backend="scan")
    assert plan is None and "scan" in reason

    class Walk(TransitionKernel):
        pass

    plan, reason = resolve_backend(Walk(model), XOR, 8192, 256, platform="cuda")
    assert plan is None and "no kernel backend yet" in reason
    lr = MLP(loss=lambda out, y: out.sum(), dtype=torch.float32, device="cpu",
             hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
    plan, reason = resolve_backend(HMC(lr, step=0.05), XOR, 8192, 256, platform="cuda")
    assert plan is None and "kernel-compatible" in reason


def test_minibatch_schedule_goes_generic():
    x, y = (torch.as_tensor(a) for a in XOR)
    sched = BatchSchedule(torch.stack([x[:2], x[2:]]), torch.stack([y[:2], y[2:]]))
    plan, reason = resolve_backend(HMC(xor_model(), step=0.05), sched, 8192, 256,
                                   platform="cuda")
    assert plan is None and "full-batch" in reason


def test_cpu_platform_goes_generic_and_auto_equals_scan():
    """Model and data on the CPU: no plan, and ``backend="auto"`` is exactly
    the generic path."""
    plan, reason = resolve_backend(HMC(xor_model(), step=0.05), XOR, 8192, 256)
    assert plan is None and "CUDA" in reason
    theta0s = 0.1 * torch.randn(4, 9, generator=torch.Generator().manual_seed(1))
    out = [sample_chains(HMC(xor_model(), step=0.05), torch.Generator().manual_seed(2),
                         theta0s, XOR, 30, return_arrays=True, backend=backend)
           for backend in ("auto", "scan")]
    assert torch.equal(out[0]["sample"], out[1]["sample"])


def test_cache_keys_by_value():
    a = dict(step=0.1, tuner=HMCDATuner(l=0.5), temperatures=np.arange(4.0))
    b = dict(step=0.1, tuner=HMCDATuner(l=0.5), temperatures=np.arange(4.0))
    assert dispatch._freeze(a) == dispatch._freeze(b)  # equal configs, other objects
    b["tuner"].d = 0.9
    assert dispatch._freeze(a) != dispatch._freeze(b)
    assert dispatch._freeze(dict(a, step=0.2)) != dispatch._freeze(a)
    x1, y = np.zeros((4, 2), np.float32), np.zeros((4, 1), np.float32)
    assert dispatch._data_fingerprint(x1, y) == dispatch._data_fingerprint(x1.copy(), y)
    assert dispatch._data_fingerprint(x1, y) != dispatch._data_fingerprint(x1 + 1, y)

    kernel = HMC(xor_model(), step=0.05, num_steps=3)
    gen = torch.Generator().manual_seed(0)
    theta0s = torch.zeros(128, 9)
    for _ in range(2):
        sample_chains(kernel, gen, theta0s, XOR, 6, backend="resident", platform="cuda")
    sample_chains(kernel, gen, theta0s, (XOR[0].copy(), XOR[1].copy()), 6,
                  backend="resident", platform="cuda")
    assert len(kernel._backend_cache) == 1  # the same values reuse one function
    kernel.step0 = 0.07
    sample_chains(kernel, gen, theta0s, XOR, 6, backend="resident", platform="cuda")
    assert len(kernel._backend_cache) == 2


@pytest.mark.parametrize("record_keys", [None, ("sample", "target_val", "accepted")])
def test_slice_runs_the_plain_kernel_into_chainlists(record_keys):
    """``sample_chains(..., backend="resident", platform="cuda")`` on CPU
    tensors: dispatch, the plain version of the kernel through
    ``run_kernel_backend``, the [C, kept, P] re-layout, the accepted flags
    (derived, or the kernel's exact ones with target_val) and ``ChainLists``
    statistics; no kernel launch."""
    model = iris_model()
    x, y = iris_data()
    C, iters, burnin = 128, 60, 30
    theta0s = 0.1 * torch.randn(C, model.num_params, generator=torch.Generator().manual_seed(3))
    kernel = HMC(model, tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64)
    before = resident_hmc.launch_counts[resident_hmc.KERNEL]
    chains, state = sample_chains(kernel, torch.Generator().manual_seed(4), theta0s, (x, y),
                                  iters, burnin, record_keys=record_keys, return_state=True,
                                  backend="resident", platform="cuda")
    assert resident_hmc.launch_counts[resident_hmc.KERNEL] == before
    samples = chains.get_samples()
    assert samples.shape == (C, iters - burnin, model.num_params)
    assert set(chains.keys()) == set(record_keys or ("sample", "accepted"))
    flags = chains.tensor("accepted")
    assert flags.dtype == torch.int32 and flags.shape == (C, iters - burnin)
    moved = torch.any(samples[:, 1:] != samples[:, :-1], dim=-1)
    assert torch.equal(flags[:, 1:].bool(), moved)
    assert 0.3 < chains.acceptance_summary() < 1.0
    if record_keys:
        vals, _ = model.upto_grad_log_target(samples.reshape(-1, model.num_params),
                                             torch.as_tensor(x, dtype=torch.float32),
                                             torch.as_tensor(y, dtype=torch.float32))
        torch.testing.assert_close(chains.tensor("target_val").reshape(-1), vals,
                                   rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(state.sample, samples[:, -1])
    summary = type(chains).from_arrays({"sample": samples[:8, :, :3]}).summary()
    assert np.isfinite(summary["multi_rhat"]) and np.isfinite(summary["multi_ess"])


def test_sample_chain_takes_chain_zero_of_a_block():
    kernel = HMC(xor_model(), step=0.05, num_steps=5)
    chain = sample_chain(kernel, torch.Generator().manual_seed(0), torch.zeros(9), XOR, 20, 5,
                         backend="resident", platform="cuda")
    assert chain.get_samples().shape == (15, 9) and len(chain) == 15
    assert 0 < chain.acceptance_rate() <= 1


def test_minibatch_schedule_runs_the_generic_path_with_recompute():
    """``BatchSchedule.from_dataset`` shuffles once with a torch.Generator and
    drops the uneven tail; a minibatch run takes the generic path, which
    recomputes the current target on each incoming batch."""
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    sched = BatchSchedule.from_dataset(ds, batch_size=40, generator=torch.Generator().manual_seed(0))
    assert sched.num_batches == 3 and sched.x.shape == (3, 40, 4) and sched.y.shape == (3, 40, 3)
    rows = {tuple(r) for r in sched.x.reshape(-1, 4).tolist()}
    assert rows <= {tuple(r) for r in ds.x.tolist()}
    assert not torch.equal(sched.x.reshape(-1, 4), torch.as_tensor(ds.x[:120]))  # shuffled
    assert BatchSchedule.from_dataset(ds).num_batches == 1
    with pytest.raises(ValueError, match="uneven"):
        BatchSchedule.from_dataset(ds, batch_size=40, drop_last=False)
    kernel = HMC(iris_model(), step=0.02, num_steps=3)
    chains = sample_chains(kernel, torch.Generator().manual_seed(1),
                           0.1 * torch.randn(4, 27, generator=torch.Generator().manual_seed(2)),
                           sched.to(dtype=torch.float32), 9, 3, backend="auto",
                           platform="cuda")
    assert kernel.recompute_current and chains.get_samples().shape == (4, 6, 27)


@pytest.mark.parametrize("chains,block", [(131072, 8192), (8192, 8192), (2048, 2048),
                                          (3072, 1024)])
@pytest.mark.parametrize("sampler", ["hmc", "mh", "mala"])
def test_auto_sends_small_data_to_dense(sampler, chains, block):
    """XOR (4 rows) under ``auto``: the dense kernel of each sampler, with
    the largest block of (8192, 4096, 2048, 1024) that divides the chains."""
    kernel = {"hmc": HMC(xor_model(), step=0.05, num_steps=10),
              "mh": MetropolisHastings(xor_model(), scale=0.1),
              "mala": MALA(xor_model(), step=0.01)}[sampler]
    plan, reason = resolve_backend(kernel, XOR, chains, 2048, 1024, platform="cuda")
    assert plan is not None, reason
    maker = {"hmc": "make_resident_hmc_dense", "mh": "make_resident_mh_dense",
             "mala": "make_resident_mala_dense"}[sampler]
    assert plan.backend == "dense" and plan.maker.__name__ == maker
    assert plan.chain_block == block
    assert plan.kwargs["num_burnin_iters"] == 1024
    if sampler == "mh":
        assert plan.kwargs["scale"] == 0.1
    if sampler == "mala":
        assert plan.kwargs["step"] == 0.01


@pytest.mark.parametrize("sampler,maker,block", [
    ("mh", "make_resident_mh", 4096), ("mala", "make_resident_mala", 4096)])
def test_auto_sends_iris_walks_to_resident(sampler, maker, block):
    kernel = (MetropolisHastings(iris_model(), scale=0.1) if sampler == "mh"
              else MALA(iris_model(), step=0.003))
    plan, reason = resolve_backend(kernel, iris_data(), 32768, 2048, 1024, platform="cuda")
    assert plan is not None, reason
    assert plan.backend == "resident" and plan.maker.__name__ == maker
    assert plan.chain_block == block
    plan, _ = resolve_backend(kernel, iris_data(), 384, 2048, platform="cuda")
    assert plan.chain_block == 128


def test_walks_with_chains_off_the_dense_blocks_go_resident():
    plan, _ = resolve_backend(MALA(xor_model(), step=0.01), XOR, 1536, 256, platform="cuda")
    assert plan.backend == "resident" and plan.chain_block == 512


@pytest.mark.parametrize("kernel,reason", [
    (lambda m: MetropolisHastings(m, symmetric=False), "symmetric"),
    (lambda m: MetropolisHastings(m, kernel=MultivariateNormalKernel(np.eye(9))), "symmetric"),
    (lambda m: MetropolisHastings(m, kernel=NormalKernel(np.full(9, 0.1))), "scalar")])
def test_mh_outside_the_kernels_goes_generic(kernel, reason):
    """Only a symmetric Normal walk of one scale has a kernel: anything else
    runs the generic path under ``auto`` and raises when a kernel is asked."""
    for data in (XOR, iris_data()):
        model = xor_model() if data is XOR else iris_model()
        plan, why = resolve_backend(kernel(model), data, 8192, 256, platform="cuda")
        assert plan is None and reason in why
    with pytest.raises(ValueError, match=reason):
        resolve_backend(kernel(xor_model()), XOR, 8192, 256, platform="cuda",
                        backend="resident")


@pytest.mark.parametrize("keys,eligible,extras", [
    (("sample", "grad_val"), False, None), (("sample",), True, False),
    (("sample", "target_val", "accepted"), True, True)])
@pytest.mark.parametrize("sampler", ["mh", "mala"])
def test_walk_record_key_contract(sampler, keys, eligible, extras):
    kernel = (MetropolisHastings(xor_model(), scale=0.1) if sampler == "mh"
              else MALA(xor_model(), step=0.01))
    plan, reason = resolve_backend(kernel, XOR, 8192, 256, platform="cuda", record_keys=keys)
    if eligible:
        assert plan is not None and plan.kwargs["record_extras"] is extras
    else:
        assert plan is None and "grad_val" in reason


@pytest.mark.parametrize("sampler,module", [
    ("hmc", resident_hmc_dense), ("mh", resident_walk_dense), ("mala", resident_walk_dense),
    ("iris_mh", resident_walk), ("iris_mala", resident_walk)])
def test_walk_and_dense_slices_run_the_plain_kernels_into_chainlists(sampler, module):
    """``sample_chains(..., backend="auto", platform="cuda")`` on CPU tensors:
    dispatch picks the dense kernels for XOR and the resident walks for
    iris, runs their plain versions through ``run_kernel_backend`` and
    returns ``ChainLists`` with the derived accepted flags; no launch."""
    iris = sampler.startswith("iris")
    model = iris_model() if iris else xor_model()
    data = iris_data() if iris else XOR
    kernel = {"hmc": HMC(model, step=0.3, num_steps=5),
              "mh": MetropolisHastings(model, scale=0.3), "mala": MALA(model, step=0.2),
              "iris_mh": MetropolisHastings(model, scale=0.05),
              "iris_mala": MALA(model, step=0.003)}[sampler]
    C, iters, burnin = (128, 30, 10) if iris else (1024, 30, 10)
    theta0s = 0.1 * torch.randn(C, model.num_params, generator=torch.Generator().manual_seed(5))
    before = module.launch_counts[module.KERNEL]
    chains, state = sample_chains(kernel, torch.Generator().manual_seed(6), theta0s, data, iters,
                                  burnin, return_state=True, backend="auto", platform="cuda")
    assert module.launch_counts[module.KERNEL] == before
    samples = chains.get_samples()
    assert samples.shape == (C, iters - burnin, model.num_params)
    flags = chains.tensor("accepted")
    assert flags.dtype == torch.int32
    assert torch.equal(flags[:, 1:].bool(), torch.any(samples[:, 1:] != samples[:, :-1], dim=-1))
    assert 0.05 < chains.acceptance_summary() < 1.0
    torch.testing.assert_close(state.sample, samples[:, -1])
    assert type(state).__name__ == {"hmc": "HMCState", "mala": "MALAState"}.get(
        sampler.replace("iris_", ""), "MHState")


def iris4323_model():
    return MLP(loss=loss_functions["multiclass_classification"], dtype=torch.float32,
               device="cpu", hparams=mlp.Hyperparameters(
                   dims=[4, 3, 2, 3], activations=[mlp.sigmoid, mlp.sigmoid, None]))


@pytest.mark.parametrize("chains,block", [(32768, 8192), (3072, 1024)])
def test_gibbs_auto_sends_xor_to_dense(chains, block):
    kernel = Gibbs(xor_model(), scales=0.5, node_subblock_size=[1, None, 2])
    plan, reason = resolve_backend(kernel, XOR, chains, 2048, 1024, platform="cuda")
    assert plan is not None, reason
    assert plan.backend == "dense" and plan.maker.__name__ == "make_resident_gibbs_dense"
    assert plan.chain_block == block and plan.acc_kind == "per_block"
    assert plan.kwargs["scales"] == [0.5] * 3
    assert plan.kwargs["node_subblock_size"] == [1, None, 2]


@pytest.mark.parametrize("chains,block", [(32768, 4096), (384, 128)])
def test_gibbs_auto_sends_iris_to_resident_without_the_tpu_cap(chains, block):
    """No cap of 512 chains as the JAX package's VMEM cache has: the block
    only has to divide the chains."""
    plan, reason = resolve_backend(Gibbs(iris4323_model(), scales=0.1), iris_data(), chains,
                                   2048, 1024, platform="cuda")
    assert plan is not None, reason
    assert plan.backend == "resident" and plan.maker.__name__ == "make_resident_gibbs"
    assert plan.chain_block == block and plan.acc_kind == "per_block"


def test_gibbs_indivisible_chains_go_generic_and_dense_on_iris_raises():
    plan, reason = resolve_backend(Gibbs(xor_model(), scales=0.5), XOR, 1000, 256,
                                   platform="cuda")
    assert plan is None and "Gibbs needs chains divisible by 128" in reason
    plan, _ = resolve_backend(Gibbs(xor_model(), scales=0.5), XOR, 1536, 256, platform="cuda")
    assert plan.backend == "resident" and plan.chain_block == 512
    with pytest.raises(ValueError, match="MAX_DENSE_ROWS"):
        resolve_backend(Gibbs(iris4323_model()), iris_data(), 8192, 256, platform="cuda",
                        backend="dense")
    with pytest.raises(ValueError, match="divisible by 1024"):
        resolve_backend(Gibbs(xor_model()), XOR, 1536, 256, platform="cuda", backend="dense")


@pytest.mark.parametrize("data,module,C", [("xor", resident_walk_dense, 1024),
                                           ("iris", resident_walk, 128)])
def test_gibbs_slices_run_the_plain_kernels_into_chainlists(data, module, C):
    """``sample_chains(Gibbs, backend="auto", platform="cuda")`` on CPU
    tensors: the dense plan for XOR, the resident one for iris, their plain
    versions, moved flags [C, kept] whose first row is 1 (the counts are per
    sub-block, as in the JAX package), the per-sub-block counts in the
    module's ``last_info``, a ``GibbsState``; no launch."""
    model = xor_model() if data == "xor" else iris4323_model()
    xy = XOR if data == "xor" else iris_data()
    kernel = Gibbs(model, scales=0.5 if data == "xor" else 0.1)
    iters, burnin = 30, 10
    theta0s = 0.1 * torch.randn(C, model.num_params, generator=torch.Generator().manual_seed(5))
    before = dict(module.launch_counts)
    chains, state = sample_chains(kernel, torch.Generator().manual_seed(6), theta0s, xy, iters,
                                  burnin, return_state=True, backend="auto", platform="cuda")
    assert module.launch_counts == before
    samples, flags = chains.get_samples(), chains.tensor("accepted")
    assert samples.shape == (C, iters - burnin, model.num_params)
    assert flags.shape == (C, iters - burnin) and flags.dtype == torch.int32
    assert bool((flags[:, 0] == 1).all())
    assert torch.equal(flags[:, 1:].bool(), torch.any(samples[:, 1:] != samples[:, :-1], dim=-1))
    counts = module.last_info[module.GIBBS_KERNEL]["accept_counts"]
    assert counts.shape == (C, kernel.num_sub_blocks)
    assert bool(((counts > 0) & (counts <= iters - burnin)).any())
    assert type(state).__name__ == "GibbsState" and state.accepted.shape == counts.shape
    torch.testing.assert_close(state.sample, samples[:, -1])
    chain = sample_chain(kernel, torch.Generator().manual_seed(7), theta0s[0], xy, iters, burnin,
                         backend="auto", platform="cuda")
    assert chain.get_samples().shape == (iters - burnin, model.num_params)


def test_gibbs_record_key_contract():
    kernel = Gibbs(xor_model(), scales=0.5)
    plan, reason = resolve_backend(kernel, XOR, 8192, 256, platform="cuda",
                                   record_keys=("sample", "target_val", "accepted"))
    assert plan is not None and plan.kwargs["record_extras"] is True
    chains = sample_chains(kernel, torch.Generator().manual_seed(1),
                           0.1 * torch.randn(1024, 9, generator=torch.Generator().manual_seed(2)),
                           XOR, 20, 5, record_keys=("sample", "target_val", "accepted"),
                           backend="dense", platform="cuda")
    samples = chains.get_samples()
    assert torch.equal(chains.tensor("accepted")[:, 1:].bool(),
                       torch.any(samples[:, 1:] != samples[:, :-1], dim=-1))
    vals = xor_model().log_target(samples.reshape(-1, 9), *(torch.as_tensor(a, dtype=torch.float32)
                                                            for a in XOR))
    torch.testing.assert_close(chains.tensor("target_val").reshape(-1), vals, rtol=1e-5,
                               atol=1e-5)


# ---- faults of the kernel path, each fixed with its test ----


def tanh_mlp():
    return MLP(loss=loss_functions["binary_classification"], dtype=torch.float32, device="cpu",
               hparams=mlp.Hyperparameters(dims=[2, 2, 1], activations=[torch.tanh, mlp.sigmoid]))


def test_non_sigmoid_hidden_units_and_other_priors_are_not_kernel_compatible():
    """The kernels compute the sigmoid network under an IID Normal prior: a
    tanh MLP (or another prior) goes generic under ``auto`` and raises when a
    kernel is asked for, on every entry point."""
    from eeyore_tpu_torch.ops import make_fused_log_target_vg
    from eeyore_tpu_torch.samplers.dispatch import resolve_tempering

    plan, reason = resolve_backend(HMC(tanh_mlp(), step=0.05), XOR, 8192, 256, platform="cuda")
    assert plan is None and "sigmoid" in reason
    with pytest.raises(ValueError, match="sigmoid"):
        resolve_backend(MALA(tanh_mlp(), step=0.05), XOR, 8192, 256, platform="cuda",
                        backend="resident")
    with pytest.raises(ValueError, match="sigmoid"):
        make_fused_log_target_vg(tanh_mlp(), *XOR, device="cpu")
    pp = PowerPosteriorSampler(tanh_mlp(), num_chains=4, swap_scheme="even_odd")
    plan, reason = resolve_tempering(pp, XOR, 64, 16, platform="cuda")
    assert plan is None and "sigmoid" in reason
    with pytest.raises(ValueError, match="sigmoid"):
        resolve_tempering(pp, XOR, 64, 16, platform="cuda", backend="dense")

    class StudentPrior:
        loc, scale = torch.zeros(9), torch.ones(9)

        def log_prob(self, theta):
            return -torch.log1p(theta * theta)

    model = xor_model()
    model.prior = StudentPrior()
    plan, reason = resolve_backend(HMC(model, step=0.05), XOR, 8192, 256, platform="cuda")
    assert plan is None and "IIDNormalPrior" in reason
    torch_sigmoid = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                        device="cpu", hparams=mlp.Hyperparameters(
                            dims=[2, 2, 1], activations=[torch.sigmoid, torch.sigmoid]))
    plan, _ = resolve_backend(HMC(torch_sigmoid, step=0.05), XOR, 8192, 256, platform="cuda")
    assert plan is not None


def test_kernel_path_state_of_a_tuner_without_e0_starts_at_step0():
    """As JAX's init without a key: the final state that ``return_state``
    builds after a kernel run runs no step heuristic, so it starts at
    ``step`` and leaves the global generator alone."""
    kernel = HMC(xor_model(), step=0.07, num_steps=4, tuner=HMCDATuner(l=0.3))
    theta0s = 0.1 * torch.randn(1024, 9, generator=torch.Generator().manual_seed(1))
    before = torch.get_rng_state()
    _, state = sample_chains(kernel, torch.Generator().manual_seed(2), theta0s, XOR, 12, 6,
                             return_state=True, backend="auto", platform="cuda")
    assert torch.equal(torch.get_rng_state(), before)
    assert bool((state.step == 0.07).all())
    assert bool((state.num_steps == kernel.tuner.num_steps(state.step)).all())
    # the generic path hands init a generator (the global one when None), as
    # the JAX runner hands it a key, and runs the heuristic
    generic = HMC(xor_model(), step=0.07, num_steps=4, tuner=HMCDATuner(l=0.3))
    torch.manual_seed(5)
    _, state = sample_chains(generic, None, theta0s[:4], XOR, 4, 3, return_state=True,
                             backend="scan")
    assert not torch.equal(torch.get_rng_state(), before)


def test_kernel_cache_keys_on_the_prior_and_the_temperature():
    """A maker bakes in the prior and the temperature, so a change of either
    between two calls builds a new function, whose values differ."""
    kernel = MALA(xor_model(), step=0.1)
    theta0s = 0.1 * torch.randn(1024, 9, generator=torch.Generator().manual_seed(1))
    keys = ("sample", "target_val", "accepted")

    def run():
        return sample_chains(kernel, torch.Generator().manual_seed(3), theta0s, XOR, 8, 2,
                             record_keys=keys, backend="auto", platform="cuda")

    first = run().tensor("target_val")
    assert torch.equal(run().tensor("target_val"), first) and len(kernel._backend_cache) == 1
    kernel.model.prior = IIDNormalPrior.isotropic(9, 3.0, dtype=torch.float32, device="cpu")
    second = run().tensor("target_val")
    assert len(kernel._backend_cache) == 2 and not torch.equal(second, first)
    kernel.model.temperature = 0.5
    third = run().tensor("target_val")
    assert len(kernel._backend_cache) == 3 and not torch.equal(third, second)


# ---- tempering ladders (tests/test_dispatch.py:275-330) ----


def test_even_odd_ladder_resolves_dense_on_xor():
    pp = PowerPosteriorSampler(xor_model(), num_chains=8, sampler="MALA",
                               sampler_kwargs={"step": 0.05}, between_step=5,
                               swap_scheme="even_odd")
    plan, reason = resolve_tempering(pp, XOR, 256, 64, platform="cuda")
    assert plan is not None, reason
    assert plan.backend == "dense" and plan.maker.__name__ == "make_resident_tempering_dense"
    assert plan.chain_block == 1024
    assert plan.kwargs["num_rungs"] == 8 and plan.kwargs["between_step"] == 5
    assert plan.kwargs["step"] == 0.05 and plan.kwargs["num_burnin_iters"] == 64
    plan, _ = resolve_tempering(pp, XOR, 256, 64, platform="cuda", backend="resident")
    assert plan.backend == "resident" and plan.chain_block == 128
    iris_pp = PowerPosteriorSampler(iris_model(), num_chains=8, swap_scheme="even_odd")
    plan, _ = resolve_tempering(iris_pp, iris_data(), 256, 64, platform="cuda")
    assert plan.backend == "resident" and plan.maker.__name__ == "make_resident_tempering"
    with pytest.raises(ValueError, match="MAX_DENSE_ROWS"):
        resolve_tempering(iris_pp, iris_data(), 256, 64, platform="cuda", backend="dense")


def test_categorical_and_cpu_ladders_stay_generic():
    cat = PowerPosteriorSampler(xor_model(), num_chains=8, sampler="MALA",
                                swap_scheme="categorical")
    plan, reason = resolve_tempering(cat, XOR, 256, 64, platform="cuda")
    assert plan is None and "categorical" in reason
    eo = PowerPosteriorSampler(xor_model(), num_chains=8, sampler="MALA", swap_scheme="even_odd")
    plan, reason = resolve_tempering(eo, XOR, 256, 64)
    assert plan is None and "CUDA" in reason
    plan, reason = resolve_tempering(eo, XOR, 256, 64, backend="scan")
    assert plan is None and "scan" in reason
    plan, reason = resolve_tempering(eo, XOR, 256, 64, platform="cuda",
                                     record_keys=("sample", "grad_val"))
    assert plan is None and "grad_val" in reason
    kw = PowerPosteriorSampler(xor_model(), num_chains=8, sampler="MetropolisHastings",
                               sampler_kwargs={"kernel": None}, swap_scheme="even_odd")
    plan, reason = resolve_tempering(kw, XOR, 256, 64, platform="cuda")
    assert plan is None and "kernel-mappable" in reason


def test_default_step_and_scale_match_the_inner_samplers():
    mala = PowerPosteriorSampler(xor_model(), num_chains=8, sampler="MALA",
                                 swap_scheme="even_odd")
    plan, _ = resolve_tempering(mala, XOR, 256, 64, platform="cuda")
    assert plan.kwargs["step"] == 0.1 and plan.kwargs["sampler"] == "MALA"
    mh = PowerPosteriorSampler(xor_model(), num_chains=8, sampler="MetropolisHastings",
                               swap_scheme="even_odd")
    plan, _ = resolve_tempering(mh, XOR, 256, 64, platform="cuda")
    assert plan.kwargs["step"] == 1.0
    np.testing.assert_array_equal(plan.kwargs["temperatures"], mh.temperatures.numpy())


@pytest.mark.parametrize("L,block,reason", [(4, 1024, None), (256, 2048, None),
                                            (3, None, "divisible"),
                                            (512, None, "WALK_BLOCK")])
def test_ladders_that_no_block_holds_get_a_reason(L, block, reason):
    pp = PowerPosteriorSampler(xor_model(), num_chains=L, swap_scheme="even_odd")
    plan, why = resolve_tempering(pp, XOR, 256, 64, platform="cuda")
    if reason is None:
        assert plan.chain_block == block and (block // 8) % L == 0
    else:
        assert plan is None and reason in why
        with pytest.raises(ValueError, match=reason):
            resolve_tempering(pp, XOR, 256, 64, platform="cuda", backend="resident")


# The parent's routing of each ladder length (the ladder move's lanes changed
# no decision): iris on the staged kernel in the smallest block of whole
# ladders, XOR on the dense one (auto) or the staged one (resident); beyond
# WALK_BLOCK rungs the generic ladder. And the lanes a chain of the staged
# ladder on iris: one thread a chain for a ladder that a block of lane
# chains does not hold (64 and 256 rungs); staged XOR one thread a chain.
LADDER_ROUTES = [(2, ("resident", 128), ("dense", 1024), ("resident", 128), 8, 1),
                 (8, ("resident", 128), ("dense", 1024), ("resident", 128), 8, 1),
                 (64, ("resident", 128), ("dense", 1024), ("resident", 128), 1, 1),
                 (256, ("resident", 256), ("dense", 2048), ("resident", 256), 1, 1),
                 (257, None, None, None, None, None)]


@pytest.mark.parametrize("L,iris,xor_auto,xor_resident,iris_lanes,xor_lanes", LADDER_ROUTES)
def test_ladder_routing_and_lanes_by_ladder_length(monkeypatch, L, iris, xor_auto, xor_resident,
                                                   iris_lanes, xor_lanes):
    from eeyore_tpu_torch.ops.mlp_math import prepare_data

    monkeypatch.setattr(resident_walk, "TEMPERING_LANES", 8)
    for model, data, backend, want, lanes in (
            (iris_model(), iris_data(), "auto", iris, iris_lanes),
            (xor_model(), XOR, "auto", xor_auto, None),
            (xor_model(), XOR, "resident", xor_resident, xor_lanes)):
        pp = PowerPosteriorSampler(model, num_chains=L, swap_scheme="even_odd")
        if want is None and backend == "resident":
            with pytest.raises(ValueError, match="WALK_BLOCK"):
                resolve_tempering(pp, data, 256, 64, platform="cuda", backend=backend)
            continue
        plan, reason = resolve_tempering(pp, data, 256, 64, platform="cuda", backend=backend)
        if want is None:
            assert plan is None and "WALK_BLOCK" in reason
            continue
        assert (plan.backend, plan.chain_block) == want, (backend, reason)
        if lanes is not None:
            n_rows = prepare_data(model, *data)[0].shape[0]
            assert resident_walk.tempering_lanes(n_rows, L, plan.chain_block) == lanes


@pytest.mark.parametrize("C,chain_block,L,lanes,want", [
    (128, 128, 8, 8, 64),     # the iris ladder's entry point: 16 blocks, one ladder each
    (32768, 128, 8, 8, 256),  # at size: blocks of 256 fill the card
    (32768, 4096, 8, 8, 256), (256, 256, 32, 8, 256),
    # one thread a chain, by the same rule: a small launch in blocks of one
    # ladder or of a warp, at size blocks that fill the card
    (128, 128, 8, 1, 32), (1024, 1024, 64, 1, 64), (256, 256, 256, 1, 256),
    (32768, 4096, 8, 1, 128)])
def test_ladder_blocks_spread_a_small_launch(C, chain_block, L, lanes, want):
    max_threads = 1024 if lanes == 1 else resident_walk.TEMPERING_BLOCK
    got = resident_walk.ladder_threads(max_threads, chain_block, L, lanes, C, 132)
    assert got == want and got % (L * lanes) == 0 and (C * lanes) % got == 0


def test_run_auto_equals_scan_off_the_card():
    pp = PowerPosteriorSampler(xor_model(), num_chains=4, sampler="MALA",
                               sampler_kwargs={"step": 0.05}, swap_scheme="even_odd")
    a = pp.run(torch.Generator().manual_seed(0), 0.1 * torch.ones(9), XOR, 60, 20)
    b = pp.run(torch.Generator().manual_seed(0), 0.1 * torch.ones(9), XOR, 60, 20,
               backend="scan")
    assert torch.equal(a.get_chain(3, key="sample"), b.get_chain(3, key="sample"))
    assert a.num_chains() == 4


@pytest.mark.parametrize("data,module,sampler,backend", [
    ("xor", resident_walk_dense, "MALA", "auto"),
    ("iris", resident_walk, "MetropolisHastings", "resident")])
def test_ladder_slice_runs_the_plain_kernels_into_chainlists(data, module, sampler, backend):
    """``run(backend=..., platform="cuda")`` on CPU tensors: the dense plan
    for XOR under ``auto``, the resident one for iris, their plain versions, tempered
    ``target_val`` (the kernel's value times the rung's temperature), exact
    moved flags, the counts [C, 2] in the module's ``last_info``, and with
    ``all_ladders`` every ladder of the block, ladder-major; no launch."""
    model = xor_model() if data == "xor" else iris_model()
    xy = XOR if data == "xor" else iris_data()
    kw = {"step": 0.05} if sampler == "MALA" else {"scale": 0.05}
    pp = PowerPosteriorSampler(model, num_chains=8, sampler=sampler, sampler_kwargs=kw,
                               between_step=4, swap_scheme="even_odd")
    iters, burnin = 24, 8
    keys = ("sample", "target_val", "accepted")
    theta0 = 0.1 * torch.randn(8, model.num_params, generator=torch.Generator().manual_seed(5))
    before = dict(module.launch_counts)
    one = pp.run(torch.Generator().manual_seed(6), theta0, xy, iters, burnin, record_keys=keys,
                 backend=backend, platform="cuda")
    every = pp.run(torch.Generator().manual_seed(6), theta0, xy, iters, burnin, record_keys=keys,
                   backend=backend, platform="cuda", all_ladders=True)
    assert module.launch_counts == before
    cb = 1024 if data == "xor" else 128
    assert one.num_chains() == 8 and every.num_chains() == cb
    samples = every.get_samples()
    assert samples.shape == (cb, iters - burnin, model.num_params)
    assert torch.equal(one.get_samples(), samples[:8])
    tx, ty = (torch.as_tensor(a, dtype=torch.float32) for a in xy)
    base = model.log_target(samples.reshape(-1, model.num_params), tx, ty).reshape(cb, -1)
    temps = pp.temperatures.float().repeat(cb // 8)
    torch.testing.assert_close(every.tensor("target_val"), base * temps[:, None], rtol=1e-4,
                               atol=1e-3)
    flags = every.tensor("accepted")
    assert flags.dtype == torch.int32
    assert torch.equal(flags[:, 1:].bool(), torch.any(samples[:, 1:] != samples[:, :-1], dim=-1))
    counts = module.last_info[module.TEMPERING_KERNEL]["accept_counts"]
    assert counts.shape == (cb, 2) and 0 < counts[:, 1].sum()
    assert every.get_chain(pp.default_indicator()).shape == (iters - burnin, model.num_params)
    # the derived flags without extras: moved against the previous row, the first row 1
    derived = pp.run(torch.Generator().manual_seed(6), theta0, xy, iters, burnin,
                     platform="cuda")
    assert set(derived.keys()) == {"sample", "accepted"}
    assert bool((derived.tensor("accepted")[:, 0] == 1).all())
    with pytest.raises(ValueError, match="theta0"):
        pp.run(torch.Generator().manual_seed(6), theta0[:6], xy, iters, burnin,
               platform="cuda")


# ---- SMC (tests/test_dispatch.py::TestSMCDispatch) ----

def smc_problem(rows):
    """(port model, JAX model, x, y): XOR (4 rows) or iris (150 rows)."""
    from eeyore_tpu.models import MLP as JMLP
    from eeyore_tpu.models import loss_functions as jloss_functions
    from eeyore_tpu.models import mlp as jmlp

    if rows == 4:
        return (xor_model(), JMLP(loss=jloss_functions["binary_classification"],
                                  hparams=jmlp.Hyperparameters(dims=[2, 2, 1])), *XOR)
    return (iris_model(),
            JMLP(loss=jloss_functions["multiclass_classification"],
                 hparams=jmlp.Hyperparameters(dims=[4, 3, 3], activations=[jmlp.sigmoid, None])),
            *iris_data())


def smc_mixture(num_particles=2048, **kw):
    """A DistributionModel with a base: (port sampler, JAX sampler)."""
    import jax
    from eeyore_tpu.models import DistributionModel as JDistributionModel
    from eeyore_tpu.samplers import SMCSampler as JSMCSampler

    port = SMCSampler(DistributionModel(lambda t, x, y: -0.5 * (t * t).sum(-1), 2, device="cpu"),
                      num_particles, init_sampler=lambda gen, n: torch.randn(n, 2, generator=gen),
                      base_log_pdf=lambda t: -0.5 * (t * t).sum(-1) / 4.0, **kw)
    ref = JSMCSampler(JDistributionModel(lambda t, x, y: -0.5 * t @ t, num_params=2),
                      num_particles, init_sampler=lambda k, n: jax.random.normal(k, (n, 2)),
                      base_log_pdf=lambda t: -0.5 * t @ t / 4.0, **kw)
    return port, ref


SMC_PARTICLES = (128, 384, 1000, 1024, 2048, 3072, 4096, 8192, 16384, 24576)


@pytest.mark.parametrize("rows", [4, 150])
@pytest.mark.parametrize("mutation", ["MALA", "MH", "HMC"])
def test_resolve_smc_decides_as_jax(rows, mutation):
    """The same decision and chain_block as JAX's resolve_smc at
    platform="tpu", over particle counts: 4096 at most for up to 32 rows,
    1024 above; no kernel for HMC mutations or indivisible counts."""
    from eeyore_tpu.samplers import SMCSampler as JSMCSampler
    from eeyore_tpu.samplers.dispatch import resolve_smc as jresolve_smc

    model, jmodel, x, y = smc_problem(rows)
    for N in SMC_PARTICLES:
        cb, jreason = jresolve_smc(JSMCSampler(jmodel, N, mutation=mutation), (x, y),
                                   platform="tpu")
        plan, reason = dispatch.resolve_smc(SMCSampler(model, N, mutation=mutation), (x, y),
                                            platform="cuda")
        assert (None if plan is None else plan.chain_block) == cb, (N, reason, jreason)
        assert (plan is None) == (reason is not None)
        if plan is not None:
            assert plan.backend == "resident" and plan.maker.__name__ == "make_resident_smc"


def test_resolve_smc_closure_target_decides_as_jax():
    """A DistributionModel with a base: JAX's chain_block (1024 at most), on
    the resident plan (its closure kernel)."""
    from eeyore_tpu.samplers.dispatch import resolve_smc as jresolve_smc

    for N in SMC_PARTICLES:
        port, ref = smc_mixture(N, mutation="MH")
        cb, _ = jresolve_smc(ref, (np.zeros((1, 0)), np.zeros((1, 0))), platform="tpu")
        plan, _ = dispatch.resolve_smc(port, (np.zeros((1, 0)), np.zeros((1, 0))),
                                       platform="cuda")
        assert (None if plan is None else plan.chain_block) == cb
        if plan is not None:
            assert plan.backend == "resident"


def test_resolve_smc_refusals():
    smc = SMCSampler(xor_model(), 4096)
    plan, reason = dispatch.resolve_smc(smc, XOR)  # CPU tensors: the generic path
    assert plan is None and "CUDA" in reason
    plan, reason = dispatch.resolve_smc(smc, XOR, platform="cpu")
    assert plan is None and "CUDA" in reason
    assert dispatch.resolve_smc(smc, XOR, backend="scan") == (None, "explicit backend='scan'")
    with pytest.raises(ValueError, match="resident"):
        dispatch.resolve_smc(smc, XOR, platform="cuda", backend="dense")
    with pytest.raises(ValueError, match="divisible by 128"):
        dispatch.resolve_smc(SMCSampler(xor_model(), 1000), XOR, platform="cuda",
                             backend="resident")
    with pytest.raises(ValueError, match="HMC"):
        dispatch.resolve_smc(SMCSampler(xor_model(), 4096, mutation="HMC"), XOR,
                             platform="cuda", backend="resident")
    with pytest.raises(ValueError, match="backend must be"):
        dispatch.resolve_smc(smc, XOR, backend="gpu")
    with pytest.raises(ValueError, match="model not kernel-compatible"):
        dispatch.resolve_smc(SMCSampler(tanh_mlp(), 4096), XOR, platform="cuda",
                             backend="resident")


def test_distribution_model_without_a_base_is_refused():
    dm = DistributionModel(lambda t, x, y: -0.5 * (t * t).sum(-1), 2, device="cpu")
    with pytest.raises(ValueError, match="init_sampler"):
        SMCSampler(dm, 2048)
    port, _ = smc_mixture()
    port.base_log_pdf = None
    plan, reason = dispatch.resolve_smc(port, (np.zeros((1, 0)), np.zeros((1, 0))),
                                        platform="cuda")
    assert plan is None and "base_log_pdf" in reason


def test_tempered_model_raises_in_the_smc_maker():
    model = xor_model()
    model.temperature = 0.5
    smc = SMCSampler(model, 128, num_mutation_steps=1)
    with pytest.raises(ValueError, match="untempered"):
        smc.run(torch.Generator().manual_seed(0), XOR, platform="cuda")


@pytest.mark.parametrize("target", ["mlp", "distribution"])
def test_smc_reuses_the_runner_and_fills_log_lik_with_zeros(target):
    """Two runs over the same data share one cached runner (the counterpart
    of test_smc_reuses_compiled_anneal); both paths return zero log_lik, as
    both JAX paths do; on CPU tensors neither kernel launches (the plain
    mutation pass runs)."""
    from eeyore_tpu_torch.ops import resident_smc

    if target == "mlp":
        smc, data = SMCSampler(xor_model(), 256, betas=[0.0, 0.5, 1.0],
                               num_mutation_steps=1), XOR
    else:
        smc, _ = smc_mixture(256, betas=[0.0, 0.5, 1.0], num_mutation_steps=1)
        data = (np.zeros((1, 0)), np.zeros((1, 0)))
    launched = dict(resident_smc.launch_counts)
    gen = torch.Generator().manual_seed(0)
    state, diags = smc.run(gen, data, platform="cuda")
    runners = list(smc._backend_cache.values())
    smc.run(gen, data, platform="cuda")
    assert list(smc._backend_cache.values()) == runners and len(runners) == 1
    assert state.particles.shape == (256, 2 if target == "distribution" else 9)
    assert not state.log_lik.any() and float(state.beta) == 1.0
    assert diags["beta"].shape == (2,) and math.isfinite(diags["log_evidence"])
    assert resident_smc.launch_counts == launched  # no card here
    generic_state, _ = smc.run(gen, data, backend="scan")
    assert not generic_state.log_lik.any()


# ----------------------------------------------------------------------
# NUTS: fixed-budget and resolved max_depth="auto" kernels go to the NUTS
# kernels where JAX sends them (its resolve_backend at platform="tpu" is the
# oracle); adaptive NUTS, deep trees and an unfrozen metric stay generic
# ----------------------------------------------------------------------

def nuts_pair(rows, **kw):
    """(port NUTS, JAX NUTS, x, y) over XOR (4 rows) or iris (150 rows)."""
    from eeyore_tpu.samplers import NUTS as JNUTS
    from eeyore_tpu_torch.samplers import NUTS

    model, jmodel, x, y = smc_problem(rows)
    jkw = dict(kw)
    if "tuner" in kw:
        from eeyore_tpu.tuners.dual_averaging import HMCDATuner as JHMCDATuner

        jkw["tuner"] = JHMCDATuner(**vars(kw["tuner"]))
    return NUTS(model, **kw), JNUTS(jmodel, **jkw), x, y


NUTS_CONFIGS = {
    "fixed": dict(step=0.1, max_depth=3, fixed_budget=True),
    "fixed_tuned": dict(step=0.1, max_depth=4, fixed_budget=True, tuner=HMCDATuner(d=0.8)),
    "adaptive": dict(step=0.1, max_depth=3),
    "depth_6": dict(step=0.1, max_depth=6, fixed_budget=True),
    "depth_5": dict(step=0.1, max_depth=5, fixed_budget=True),
    "mass_adapt_unfrozen": dict(step=0.1, max_depth=3, fixed_budget=True, mass_adapt=True),
    "auto_unprobed": dict(step=0.1, max_depth="auto"),
}


def plan_summary(plan, reason):
    if plan is None:
        return None, reason
    return (plan.backend, plan.maker.__name__, plan.chain_block, plan.acc_kind,
            plan.kwargs["max_depth"], plan.kwargs["step"]), reason


@pytest.mark.parametrize("rows", [4, 150])
@pytest.mark.parametrize("config", sorted(NUTS_CONFIGS))
def test_nuts_resolves_as_jax(rows, config):
    """Maker, block, acc_kind, divergence output and reason equal JAX's,
    over chain counts and both explicit backends."""
    from eeyore_tpu.samplers.dispatch import resolve_backend as jresolve_backend

    kernel, jkernel, x, y = nuts_pair(rows, **NUTS_CONFIGS[config])
    for C in (384, 1000, 1024, 4096, 16384, 32768):
        for backend in ("auto", "resident", "dense"):
            try:
                jplan, jreason = jresolve_backend(jkernel, (x, y), C, 256, 64, platform="tpu",
                                                  backend=backend)
            except ValueError as err:
                with pytest.raises(ValueError) as raised:
                    resolve_backend(kernel, (x, y), C, 256, 64, platform="cuda", backend=backend)
                assert str(raised.value) == str(err)
                continue
            # the port reads the divergence sums wherever acc_kind is "stat";
            # JAX's extra_outputs says the same
            assert jplan is None or jplan.extra_outputs == int(jplan.acc_kind == "stat")
            want = plan_summary(jplan, jreason)
            got = plan_summary(*resolve_backend(kernel, (x, y), C, 256, 64, platform="cuda",
                                                backend=backend))
            assert got == want, (C, backend)


@pytest.mark.parametrize("rows, cap, C, want", [
    (4, 0, 4096, "dense NUTS needs chains divisible by 1024 (this card holds no tuning group "
                 "of this build)"),
    (4, 512, 4096, "dense NUTS needs chains divisible by 1024 (tuning groups of at most 512 on "
                   "this card)"),
    (150, 0, 4096, "resident NUTS needs chains divisible by 128 (this card holds no tuning "
                   "group of this build)"),
    (150, 64, 4096, "resident NUTS needs chains divisible by 128 (tuning groups of at most 64 "
                    "on this card)"),
    (150, 4096, 1000, "resident NUTS needs chains divisible by 128"),
])
def test_nuts_reason_names_the_cards_tuning_group_cap(monkeypatch, rows, cap, C, want):
    """Where the card caps a tuned NUTS run's tuning group below every block
    (the cap is asked of the build on the card, so it is given here), the
    generic fallback's reason says so, as dense HMC's does; a cap above
    JAX's own block cap adds nothing."""
    kernel, _, x, y = nuts_pair(rows, step=0.1, max_depth=3, fixed_budget=True,
                                tuner=HMCDATuner(d=0.8))
    monkeypatch.setattr(dispatch, "_nuts_group_cap", lambda *args: cap)
    if rows == 4:  # XOR falls through to the resident kernel under "auto"
        with pytest.raises(ValueError) as raised:
            resolve_backend(kernel, (x, y), C, 256, 64, platform="cuda", backend="dense")
        assert str(raised.value).endswith(f"ineligible: {want}")
        return
    plan, reason = resolve_backend(kernel, (x, y), C, 256, 64, platform="cuda")
    assert plan is None and reason == want


def test_auto_nuts_dispatches_after_its_probe_with_the_frozen_metric():
    """Unprobed, an auto kernel runs generic (JAX's reason); probed, it plans
    the dense kernel at the probed depth and step, the frozen metric
    forwarded as inv_mass, as tests/test_nuts.py::TestFrozenMetricBridge."""
    from eeyore_tpu_torch.samplers import NUTS

    model = xor_model()
    kernel = NUTS(model, step=0.1, max_depth="auto", mass_adapt=True)
    plan, reason = resolve_backend(kernel, XOR, 8192, 256, platform="cuda")
    assert plan is None and "adaptive NUTS" in reason
    kernel.resolve_auto_budget(XOR, torch.Generator().manual_seed(0), num_warmup=64,
                               num_chains=4)
    plan, reason = resolve_backend(kernel, XOR, 8192, 256, platform="cuda")
    assert plan is not None, reason
    assert plan.maker.__name__ == "make_resident_nuts_dense" and plan.chain_block == 8192
    assert plan.kwargs["max_depth"] == kernel.max_depth and plan.kwargs["step"] == kernel.step0
    np.testing.assert_allclose(plan.kwargs["inv_mass"], kernel._frozen_inv_mass)


@pytest.mark.parametrize("record_keys", [None, ("sample", "target_val", "accepted")])
def test_nuts_slice_runs_the_plain_kernel_into_chainlists(record_keys):
    """``sample_chains(NUTS(fixed_budget=True), backend="auto",
    platform="cuda")`` on CPU tensors: the dense plain version through
    dispatch, the first kept row of the derived flags set to 1 (acc_kind
    "stat"), and ``info["divergent_sums"]`` from ``run_kernel_backend``; no
    kernel launch."""
    from eeyore_tpu_torch.ops import resident_nuts, resident_nuts_dense
    from eeyore_tpu_torch.samplers import NUTS

    model = xor_model()
    C, iters, burnin = 1024, 12, 4
    theta0s = torch.randn(C, model.num_params, generator=torch.Generator().manual_seed(3))
    kernel = NUTS(model, step=2.0, max_depth=3, fixed_budget=True, tuner=HMCDATuner(d=0.8))
    launched = dict(resident_nuts.launch_counts, **resident_nuts_dense.launch_counts)
    chains = sample_chains(kernel, torch.Generator().manual_seed(4), theta0s, XOR, iters, burnin,
                           record_keys=record_keys, platform="cuda")
    assert dict(resident_nuts.launch_counts, **resident_nuts_dense.launch_counts) == launched
    samples = chains.get_samples()
    assert samples.shape == (C, iters - burnin, model.num_params)
    flags = chains.tensor("accepted")
    assert flags.dtype == torch.int32
    moved = torch.any(samples[:, 1:] != samples[:, :-1], dim=-1)
    assert torch.equal(flags[:, 1:].bool(), moved)
    if record_keys is None:
        assert bool(flags[:, 0].eq(1).all())
    else:
        assert set(chains.keys()) == set(record_keys)
    plan, _ = resolve_backend(kernel, XOR, C, iters, burnin, platform="cuda")
    _, info = dispatch.run_kernel_backend(kernel, torch.Generator().manual_seed(4), theta0s, XOR,
                                          iters, burnin, plan)
    assert info["divergent_sums"].shape == (C,) and info["accept_counts"].shape == (C,)
    assert 0.0 < float(info["accept_counts"].mean()) / info["kept"] <= 1.0
    assert float(info["divergent_sums"].max()) <= iters - burnin


# ---- the lane builds of the dense walk, the dense ladder and the SMC pass ----

def xor2321_model():
    return MLP(loss=loss_functions["binary_classification"], dtype=torch.float32, device="cpu",
               hparams=mlp.Hyperparameters(dims=[2, 3, 2, 1]))


@pytest.mark.parametrize("name,want", [
    ("config1_mh", ("dense", "make_resident_mh_dense", 8192)),
    ("config2_mala", ("dense", "make_resident_mala_dense", 8192)),
    ("xor_ladder", ("dense", "make_resident_tempering_dense", 1024)),
    ("iris_smc_mala", ("resident", "make_resident_smc", 1024)),
    ("iris_smc_mh", ("resident", "make_resident_smc", 1024))])
def test_lane_builds_leave_the_routes_unchanged(name, want):
    """Lanes a chain are decided inside the makers (the rows, the group, the
    ladder), so dispatch sends BASELINE.md configs 1 and 2 (32768 chains),
    the XOR ladder of 8 rungs and iris SMC (16384 particles) to the same
    kernels and chain blocks as before; iris SMC's chain block is JAX's."""
    from eeyore_tpu.models import MLP as JMLP
    from eeyore_tpu.models import loss_functions as jloss_functions
    from eeyore_tpu.models import mlp as jmlp
    from eeyore_tpu.samplers import SMCSampler as JSMCSampler
    from eeyore_tpu.samplers.dispatch import resolve_smc as jresolve_smc

    if name == "config1_mh":
        plan, reason = resolve_backend(MetropolisHastings(xor_model(), scale=0.1), XOR, 32768,
                                       2048, 1024, platform="cuda")
    elif name == "config2_mala":
        plan, reason = resolve_backend(MALA(xor2321_model(), step=0.01), XOR, 32768, 2048, 1024,
                                       platform="cuda")
    elif name == "xor_ladder":
        pp = PowerPosteriorSampler(xor_model(), num_chains=8, sampler="MALA",
                                   sampler_kwargs={"step": 0.05}, between_step=10,
                                   swap_scheme="even_odd")
        plan, reason = resolve_tempering(pp, XOR, 2048, 1024, platform="cuda")
    else:
        mutation = "MALA" if name == "iris_smc_mala" else "MH"
        plan, reason = dispatch.resolve_smc(SMCSampler(iris_model(), 16384, mutation=mutation),
                                            iris_data(), platform="cuda")
        jmodel = JMLP(loss=jloss_functions["multiclass_classification"],
                      hparams=jmlp.Hyperparameters(dims=[4, 3, 3],
                                                   activations=[jmlp.sigmoid, None]))
        cb, _ = jresolve_smc(JSMCSampler(jmodel, 16384, mutation=mutation), iris_data(),
                             platform="tpu")
        assert cb == want[2]
    assert plan is not None, reason
    assert (plan.backend, plan.maker.__name__, plan.chain_block) == want


# ---- dense XOR HMC and the dense Gibbs move: routes and the group cap ----

def jax_plan(kernel_name, num_chains, iters, burnin):
    """JAX's ``resolve_backend`` on XOR at platform "tpu": (backend, maker,
    chain_block)."""
    from eeyore_tpu.models import MLP as JMLP
    from eeyore_tpu.models import loss_functions as jloss_functions
    from eeyore_tpu.models import mlp as jmlp
    from eeyore_tpu.samplers import HMC as JHMC
    from eeyore_tpu.samplers import Gibbs as JGibbs
    from eeyore_tpu.samplers.dispatch import resolve_backend as jresolve_backend
    from eeyore_tpu.tuners.dual_averaging import HMCDATuner as JHMCDATuner

    jmodel = JMLP(loss=jloss_functions["binary_classification"],
                  hparams=jmlp.Hyperparameters(dims=[2, 2, 1]))
    jkernel = {"bench_hmc": lambda: JHMC(jmodel, step=0.05, num_steps=10),
               "tuned_hmc": lambda: JHMC(jmodel, step=0.1, num_steps=10,
                                         tuner=JHMCDATuner(l=0.5)),
               "gibbs": lambda: JGibbs(jmodel, scales=0.5)}[kernel_name]()
    plan, reason = jresolve_backend(jkernel, XOR, num_chains, iters, burnin, platform="tpu")
    assert plan is not None, reason
    return plan.backend, plan.maker.__name__, plan.chain_block


@pytest.mark.parametrize("name,num_chains,iters,burnin", [
    ("bench_hmc", 131072, 256, 0), ("tuned_hmc", 131072, 256, 128),
    ("gibbs", 32768, 2048, 1024)])
def test_dense_hmc_and_gibbs_builds_leave_the_routes_unchanged(name, num_chains, iters, burnin):
    """Dispatch sends bench.py's problem, a tuned XOR HMC run and XOR Gibbs
    to the dense kernels and the chain blocks JAX's dispatch gives them (a
    tuned group keeps JAX's 8192 chains)."""
    kernel = {"bench_hmc": lambda: HMC(xor_model(), step=0.05, num_steps=10),
              "tuned_hmc": lambda: HMC(xor_model(), step=0.1, num_steps=10,
                                       tuner=HMCDATuner(l=0.5)),
              "gibbs": lambda: Gibbs(xor_model(), scales=0.5)}[name]()
    plan, reason = resolve_backend(kernel, XOR, num_chains, iters, burnin, platform="cuda")
    assert plan is not None, reason
    assert (plan.backend, plan.maker.__name__, plan.chain_block) == jax_plan(
        name, num_chains, iters, burnin)
    assert plan.chain_block == 8192


class _HostArray:
    """A stand-in for a CUDA tensor of ``_dense_group_cap``: it asks only
    ``is_cuda`` and the host copy (``utils.host.host_array``)."""

    is_cuda = True

    def __init__(self, a):
        self.a = a

    def __array__(self, dtype=None, copy=None):
        return self.a


@pytest.mark.parametrize("largest_held,want_cap", [(8192, 8192), (2048, 2048)])
def test_the_dense_group_cap_asks_the_build_that_runs_the_group(monkeypatch, largest_held,
                                                                want_cap):
    """Dispatch loads the dense HMC build for the model and data once and
    asks it for the largest tuning group the card holds as one block or
    cluster: JAX's 8192 where it holds it."""
    asked = []

    def load_kernel(model, x, y):
        asked.append((model.num_params, x.shape[0]))
        return "dense build"

    def group_shape(lib, chain_block):
        assert lib == "dense build"
        if chain_block > largest_held:
            raise ValueError("no cluster holds it")
        return 512, chain_block // 512

    monkeypatch.setattr(resident_hmc_dense, "load_kernel", load_kernel)
    monkeypatch.setattr(resident_hmc_dense, "group_shape", group_shape)
    kernel = HMC(xor_model(), step=0.1, num_steps=10, tuner=HMCDATuner(l=0.5))
    cap = dispatch._dense_group_cap(kernel, _HostArray(XOR[0]), _HostArray(XOR[1]))
    assert (cap, asked) == (want_cap, [(kernel.model.num_params, XOR[0].shape[0])])
