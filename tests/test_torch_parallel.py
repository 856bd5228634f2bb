"""Port, ``parallel/`` on torch.distributed: meshes, collectives and every
sharded entry point, on a two-process Gloo group on the CPU.

One module-scoped group of two ranks (``tests/test_torch_parallel_worker.py``,
which imports no JAX) runs every case once and writes each rank's outputs;
this process gives it the numpy-seeded inputs, computes the JAX oracles and
holds each rank's block, in float64:

- ``global_logsumexp``/``global_log_ess`` over 64 numbers split 32/32
  against JAX's ``logsumexp`` and ``log_ess`` (rtol 1e-12);
- ``sample_chains_sharded``: each rank's block equals the unsharded port run
  of that block with that rank's generator, exactly; a one-rank run equals
  ``sample_chains(backend="scan")``; the pooled moments pass JAX's gates
  (``tests/test_parallel.py:39-48``), as JAX's on the 8-device mesh does;
- the two kernel runners (staged and dense, plain versions, XOR): rank r's
  outputs equal ``fn(key_seed + r*7919, block)`` exactly, in JAX's output
  layout, and the divisibility ValueError is JAX's;
- the sharded ladder (MALA and MH, 8 rungs, swaps every 2 iterations, both
  parities) equals the unsharded ``_within_moves``/``_between_moves_even_odd``
  fed the tiled within draws and the shared pair uniforms
  (``chip_smoke.replay_ladder``, which the chip check also holds two ranks
  on the card to), exactly; its cold
  and hot rungs pass JAX's gates and its cold means stand within 5 pooled
  SE of JAX's sharded ladder;
- sharded SMC on the conjugate normal: JAX's gates, and one stage given the
  whole cloud's draws equal on each rank to the rows of the one-rank stage
  (1e-9, JAX's cross-layout tolerance);
- the collectives each entry point makes: none for the chain-sharded three
  (the counterpart of ``tests/test_sharding_hlo.py``), some for the ladder
  and SMC.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.models import DistributionModel as JDistributionModel
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.parallel import chain_mesh as jchain_mesh
from eeyore_tpu.parallel import run_power_posterior_sharded as jrun_power_posterior_sharded
from eeyore_tpu.parallel import run_resident_hmc_sharded as jrun_resident_hmc_sharded
from eeyore_tpu.parallel import run_resident_tempering_sharded as jrun_resident_tempering_sharded
from eeyore_tpu.parallel import sample_chains_sharded as jsample_chains_sharded
from eeyore_tpu.samplers import MALA as JMALA
from eeyore_tpu.samplers import PowerPosteriorSampler as JPP
from eeyore_tpu.samplers.smc import log_ess as jlog_ess
from eeyore_tpu_torch.ops.resident_hmc import make_resident_hmc
from eeyore_tpu_torch.ops.resident_hmc_dense import make_resident_hmc_dense
from eeyore_tpu_torch.ops.resident_tempering import make_resident_tempering
from eeyore_tpu_torch.ops.resident_tempering_dense import make_resident_tempering_dense
from eeyore_tpu_torch.parallel import (
    chain_mesh,
    chain_sharding,
    initialize_distributed,
    ladder_mesh,
    run_power_posterior_sharded,
    run_resident_hmc_sharded,
    run_resident_tempering_sharded,
    run_smc_sharded,
    sample_chains_sharded,
)
from eeyore_tpu_torch.parallel.mesh import LocalMesh
from eeyore_tpu_torch.parallel.sharded import _smc_stage, shard_generator
from eeyore_tpu_torch.samplers import MALA, sample_chains
from chip_smoke import replay_ladder
from tests import test_torch_parallel_worker as worker

WORKER = Path(worker.__file__)
F64 = torch.float64
CPU_MESH = dict(devices="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Both sides of an exact comparison on one intra-op thread, as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_inputs(path):
    rng = np.random.default_rng(0)
    n = worker.STAGE_PARTICLES
    np.savez(path, lse_x=rng.normal(size=64), bvn_theta0s=rng.normal(size=(16, 2)), chains_seed=1,
             kernel_theta0s_128=(0.1 * rng.normal(size=(128, 9))).astype(np.float32),
             kernel_theta0s_2048=(0.1 * rng.normal(size=(2048, 9))).astype(np.float32),
             ladder_seed=5, stage_particles=rng.normal(size=(n, 1)),
             # spread weights resample (ESS ~ 13 of 256), flat ones do not
             stage_log_w_resampled=2.0 * rng.normal(size=n),
             stage_log_w_kept=0.01 * rng.normal(size=n), stage_u=rng.uniform(),
             stage_noise=rng.normal(size=(2, n, 1)), stage_uniforms=rng.uniform(size=(2, n)))
    return dict(np.load(path))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(inputs, [rank 0's outputs, rank 1's]) of one two-rank Gloo run."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    inputs = make_inputs(tmp / "inputs.npz")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(tmp / "pg"), str(rank),
                               str(tmp / "inputs.npz"), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(worker.WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    return inputs, [dict(np.load(tmp / f"rank{rank}.npz")) for rank in range(worker.WORLD)]


def gathered(ranks, key):
    """The ranks' blocks of ``key``, in rank order."""
    return np.concatenate([r[key] for r in ranks])


def jbvn_model():
    prec = jnp.asarray(np.linalg.inv(worker.COV))
    return JDistributionModel(lambda t, x, y: -0.5 * t @ prec @ t, num_params=2)


# ----------------------------------------------------------------------
# meshes
# ----------------------------------------------------------------------

def test_world_of_one_without_a_group():
    assert initialize_distributed(None) is None
    assert not torch.distributed.is_initialized()
    mesh = chain_mesh(**CPU_MESH)
    assert isinstance(mesh, LocalMesh) and mesh.mesh_dim_names == ("chains",)
    assert chain_sharding(mesh) == (0, 1, torch.device("cpu"), None)
    ladder = ladder_mesh(1, 1, **CPU_MESH)
    assert ladder.mesh_dim_names == ("chains", "temp")
    assert chain_sharding(ladder, "temp").rows(8) == slice(0, 8)
    with pytest.raises(ValueError, match="world of one"):
        chain_mesh(num_devices=2, **CPU_MESH)
    with pytest.raises(ValueError, match="axes"):
        chain_sharding(mesh, "temp")


@pytest.mark.parametrize("name,axis,want", [
    ("chain", "chains", [[0, 2, 0, 4], [1, 2, 4, 8]]),
    ("ladder12", "chains", [[0, 1, 0, 8], [0, 1, 0, 8]]),
    ("ladder12", "temp", [[0, 2, 0, 4], [1, 2, 4, 8]]),
    ("ladder21", "chains", [[0, 2, 0, 4], [1, 2, 4, 8]]),
    ("ladder21", "temp", [[0, 1, 0, 8], [0, 1, 0, 8]]),
])
def test_mesh_axes_and_rows(group, name, axis, want):
    """(rank, size, rows of 8) of each rank along each axis: a (1, 2) ladder
    mesh shards the temperatures and replicates the chains, (2, 1) the other
    way round."""
    _, ranks = group
    assert [r[f"mesh_{name}_{axis}"].tolist() for r in ranks] == want


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["global_logsumexp", "global_log_ess"])
def test_collectives_equal_jaxs(group, name):
    inputs, ranks = group
    x = jnp.asarray(inputs["lse_x"])
    want = float(jax.scipy.special.logsumexp(x) if name == "global_logsumexp" else jlog_ess(x))
    for r in ranks:
        np.testing.assert_allclose(r[name], want, rtol=1e-12)


# ----------------------------------------------------------------------
# chain-sharded generic chains
# ----------------------------------------------------------------------

def unsharded_chains(theta0s, seed, rank, iters=worker.CHAINS_ITERS, burnin=worker.CHAINS_BURNIN):
    generator = shard_generator(torch.Generator().manual_seed(seed), "cpu", rank)
    return sample_chains(MALA(worker.bvn_model(), step=0.4), generator,
                         torch.as_tensor(theta0s, dtype=F64), worker.EMPTY, iters, burnin,
                         backend="scan", return_arrays=True, return_state=True)


def test_sample_chains_blocks_equal_unsharded_runs(group):
    inputs, ranks = group
    for rank, r in enumerate(ranks):
        block = inputs["bvn_theta0s"][8 * rank:8 * (rank + 1)]
        recorded, state = unsharded_chains(block, int(inputs["chains_seed"]), rank)
        for k, v in recorded.items():
            assert np.array_equal(r[f"chains_{k}"], v.numpy()), (rank, k)
        assert np.array_equal(r["chains_final"], state.sample.numpy())


def test_sample_chains_one_rank_equals_sample_chains():
    theta0s = torch.as_tensor(np.random.default_rng(3).normal(size=(6, 2)))
    recorded, state = sample_chains_sharded(MALA(worker.bvn_model(), step=0.4),
                                            torch.Generator().manual_seed(4), theta0s,
                                            worker.EMPTY, 60, 10, mesh=chain_mesh(**CPU_MESH))
    want, want_state = unsharded_chains(theta0s, 4, 0, 60, 10)
    assert set(recorded) == set(want)
    for k in want:
        assert torch.equal(recorded[k], want[k]), k
    assert torch.equal(state.sample, want_state.sample)


def test_sample_chains_refuses_donate():
    with pytest.raises(ValueError, match="donate"):
        sample_chains_sharded(MALA(worker.bvn_model()), None, torch.zeros(2, 2, dtype=F64),
                              worker.EMPTY, 2, mesh=chain_mesh(**CPU_MESH), donate=True)


def moments_pass_jaxs_gates(samples):
    pooled = np.asarray(samples).reshape(-1, 2)
    np.testing.assert_allclose(pooled.mean(0), np.zeros(2), atol=0.08)
    np.testing.assert_allclose(np.cov(pooled, rowvar=False), worker.COV, atol=0.15)


def test_sample_chains_pooled_moments_pass_jaxs_gates(group):
    inputs, ranks = group
    samples = gathered(ranks, "chains_sample")
    assert samples.shape == (16, worker.CHAINS_ITERS - worker.CHAINS_BURNIN, 2)
    moments_pass_jaxs_gates(samples)
    jrecorded, _ = jsample_chains_sharded(
        JMALA(jbvn_model(), step=0.4), jax.random.PRNGKey(1), jnp.asarray(inputs["bvn_theta0s"]),
        (jnp.zeros((1, 0)), jnp.zeros((1, 0))), worker.CHAINS_ITERS, worker.CHAINS_BURNIN,
        mesh=jchain_mesh(axis_name="chains"))
    moments_pass_jaxs_gates(jrecorded["sample"])


# ----------------------------------------------------------------------
# the whole-loop kernel runners
# ----------------------------------------------------------------------

MAKERS = {"hmc": make_resident_hmc, "hmc_dense": make_resident_hmc_dense,
          "tempering": make_resident_tempering, "tempering_dense": make_resident_tempering_dense}


@pytest.mark.parametrize("name", list(worker.KERNEL_RUNS))
def test_kernel_runner_blocks_equal_their_calls(group, name):
    """Rank r's outputs are ``fn(key_seed + r * 7919, its block)``, in JAX's
    layout: samples [kept, C_local, P], final [C_local, P], counts [C_local
    (, 2)]."""
    inputs, ranks = group
    kw, C, chain_block = worker.KERNEL_RUNS[name]
    kw = {k: v for k, v in kw.items() if k != "dense"}
    model, x, y = worker.xor_problem()
    fn = MAKERS[name](model, x, y, num_iters=worker.KERNEL_ITERS,
                      num_burnin_iters=worker.KERNEL_BURNIN, chain_block=chain_block,
                      device="cpu", **kw)
    theta0s = torch.as_tensor(inputs[f"kernel_theta0s_{C}"])
    kept, local = worker.KERNEL_ITERS - worker.KERNEL_BURNIN, C // worker.WORLD
    for rank, r in enumerate(ranks):
        want = fn(worker.KERNEL_SEED + rank * 7919, theta0s[rank * local:(rank + 1) * local])
        for part, w in zip(("samples", "final", "counts"), want):
            assert np.array_equal(r[f"kernel_{name}_{part}"], w.numpy()), (rank, part)
        assert r[f"kernel_{name}_samples"].shape == (kept, local, 9)
        assert r[f"kernel_{name}_final"].shape == (local, 9)
        assert r[f"kernel_{name}_counts"].shape[0] == local


@pytest.mark.parametrize("name", list(worker.KERNEL_RUNS))
def test_kernel_runner_refuses_an_indivisible_count_over_two_ranks(group, name):
    _, ranks = group
    chain_block = worker.KERNEL_RUNS[name][2]
    what = "lanes" if name.startswith("tempering") else "chains"
    for r in ranks:
        assert str(r[f"kernel_{name}_indivisible"]) == (
            f"{3 * chain_block} {what} must divide over 2 shards of chain_block {chain_block}")


@pytest.mark.parametrize("runner", ["hmc", "tempering"])
def test_kernel_runner_divisibility_error_is_jaxs(runner):
    """On one shard, 96 chains in blocks of 64: both packages raise the same
    message before building anything."""
    model, x, y = worker.xor_problem()
    jmodel = JMLP(loss=jloss_functions["binary_classification"],
                  hparams=jmlp.Hyperparameters(dims=[2, 2, 1]))
    theta0s = np.zeros((96, 9), np.float32)
    if runner == "hmc":
        args, jfn, fn = (0.05, 10, 4), jrun_resident_hmc_sharded, run_resident_hmc_sharded
    else:
        args, jfn, fn = (8, 0.05), jrun_resident_tempering_sharded, run_resident_tempering_sharded
    with pytest.raises(ValueError) as jerr:
        jfn(jmodel, x, y, 1, jnp.asarray(theta0s), *args, chain_block=64,
            mesh=jchain_mesh(num_devices=1))
    with pytest.raises(ValueError) as err:
        fn(model, x, y, 1, theta0s, *args, chain_block=64, mesh=chain_mesh(**CPU_MESH))
    assert str(err.value) == str(jerr.value)


# ----------------------------------------------------------------------
# the sharded ladder
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_ranks", [1, 2])
@pytest.mark.parametrize("sampler", list(worker.LADDER_STEPS))
def test_ladder_equals_the_unsharded_moves_with_the_same_draws(group, sampler, n_ranks):
    inputs, ranks = group
    seed, iters, burnin = int(inputs["ladder_seed"]), worker.LADDER_EXACT_ITERS, \
        worker.LADDER_EXACT_BURNIN
    want = {k: v.numpy() for k, v in replay_ladder(
        worker.ladder(sampler, 2), torch.Generator().manual_seed(seed),
        torch.tensor([2.0, 2.0], dtype=F64), worker.EMPTY, iters, burnin, n_ranks).items()}
    if n_ranks == 1:
        got = {k: v.numpy() for k, v in run_power_posterior_sharded(
            worker.ladder(sampler, 2), torch.Generator().manual_seed(seed),
            torch.tensor([2.0, 2.0], dtype=F64), worker.EMPTY, iters, burnin,
            mesh=chain_mesh(axis_name="temp", **CPU_MESH)).items()}
    else:
        got = {k: gathered(ranks, f"ladder_{sampler}_{k}") for k in want}
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert got["sample"].shape == (8, iters - burnin, 2)


def batch_means_se(samples, batches=30):
    """The standard error of a chain's mean [P] by batch means."""
    n = samples.shape[0] // batches * batches
    means = np.asarray(samples[:n]).reshape(batches, -1, samples.shape[-1]).mean(1)
    return means.std(0, ddof=1) / np.sqrt(batches)


def test_ladder_cold_rung_passes_jaxs_gates_and_sits_by_jaxs(group):
    """JAX's gates (``tests/test_parallel.py:82-93``) on the cold rung, the
    last rank's last row, and its means within 5 pooled standard errors of
    JAX's sharded ladder on the same problem."""
    _, ranks = group
    cold = ranks[-1]["ladder_cold_run"][-1]
    assert cold.shape == (worker.COLD_ITERS - worker.COLD_BURNIN, 2)
    np.testing.assert_allclose(cold.mean(0), np.zeros(2), atol=0.15)
    np.testing.assert_allclose(np.cov(cold, rowvar=False), worker.COV, atol=0.3)
    pp = JPP(jbvn_model(), num_chains=8, sampler="MALA", sampler_kwargs={"step": 0.5},
             between_step=5, swap_scheme="even_odd")
    jcold = np.asarray(jrun_power_posterior_sharded(
        pp, jax.random.PRNGKey(2), jnp.asarray([2.0, 2.0]), (jnp.zeros((1, 0)), jnp.zeros((1, 0))),
        worker.COLD_ITERS, worker.COLD_BURNIN, mesh=jchain_mesh(axis_name="chains"),
        axis_name="chains")["sample"])[-1]
    se = np.sqrt(batch_means_se(cold) ** 2 + batch_means_se(jcold) ** 2)
    assert np.all(np.abs(cold.mean(0) - jcold.mean(0)) <= 5 * se), (cold.mean(0), jcold.mean(0))


def test_ladder_hot_rung_explores_wider(group):
    """``tests/test_parallel.py:95-110``: swaps every 2 iterations, the hot
    rung (rank 0's first row) varies over twice as much as the cold one."""
    _, ranks = group
    hot = ranks[0]["ladder_hot_run"][0]
    cold = ranks[-1]["ladder_hot_run"][-1]
    assert hot.var(axis=0).mean() > 2 * cold.var(axis=0).mean()


# ----------------------------------------------------------------------
# sharded SMC
# ----------------------------------------------------------------------

def test_smc_conjugate_posterior(group):
    """``tests/test_parallel.py:113-129``: the weighted posterior mean within
    0.05 of y0 / 2 and the log-evidence within 0.06 of the truth; the
    replicated diagnostics equal on both ranks."""
    _, ranks = group
    particles = gathered(ranks, "smc_particles")
    log_w = gathered(ranks, "smc_log_w")
    assert particles.shape == (worker.SMC_PARTICLES, 1)
    w = np.exp(log_w - log_w.max())
    post_mean = float(w @ particles[:, 0] / w.sum())
    assert abs(post_mean - 0.5) < 0.05
    assert abs(float(ranks[0]["smc_log_evidence"]) - (-0.25 - 0.5 * np.log(2.0))) < 0.06
    for k in ("smc_log_evidence", "smc_ess", "smc_resampled", "smc_mutation_acceptance"):
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    assert ranks[0]["smc_ess"].shape == (10,)


@pytest.mark.parametrize("case", ["resampled", "kept"])
def test_smc_stage_equals_the_one_rank_stage_rows(group, case):
    """Given the whole cloud's draws (one resampling uniform, every
    particle's noise and uniforms), each rank's stage equals its rows of the
    one-rank stage; the log-evidence, ESS and acceptance, reduced in another
    order, to 1e-9."""
    inputs, ranks = group
    smc = worker.conjugate_smc(worker.STAGE_PARTICLES)
    x, y = (torch.as_tensor(a) for a in worker.CONJUGATE_DATA)
    particles, log_w, log_z, diag = _smc_stage(
        smc, torch.as_tensor(inputs["stage_particles"]),
        torch.as_tensor(inputs[f"stage_log_w_{case}"]), torch.tensor(-0.3, dtype=F64),
        torch.tensor(0.2, dtype=F64), torch.tensor(0.5, dtype=F64), x, y,
        chain_sharding(chain_mesh(axis_name="particles", **CPU_MESH), "particles"),
        u=torch.tensor(inputs["stage_u"]), noise=torch.as_tensor(inputs["stage_noise"]),
        uniforms=torch.as_tensor(inputs["stage_uniforms"]))
    assert bool(diag["resampled"]) == (case == "resampled")
    local = worker.STAGE_PARTICLES // worker.WORLD
    for rank, r in enumerate(ranks):
        rows = slice(rank * local, (rank + 1) * local)
        np.testing.assert_allclose(r[f"stage_{case}_particles"], particles[rows].numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(r[f"stage_{case}_log_w"], log_w[rows].numpy(), rtol=0,
                                   atol=1e-9)
        for k, v in (("log_z", log_z), ("ess", diag["ess"]),
                     ("mutation_acceptance", diag["mutation_acceptance"])):
            np.testing.assert_allclose(r[f"stage_{case}_{k}"], v.numpy(), rtol=0, atol=1e-9)
        assert bool(r[f"stage_{case}_resampled"]) == bool(diag["resampled"])


def test_smc_refuses_an_indivisible_cloud_and_adaptive_betas(group):
    _, ranks = group
    for r in ranks:
        assert str(r["smc_indivisible"]) == "num_particles 4095 must divide over 2 shards"
    smc = worker.SMCSampler(worker.ConjugateNormal(), num_particles=64, betas="adaptive")
    with pytest.raises(ValueError, match="adaptive"):
        run_smc_sharded(smc, torch.Generator(), worker.CONJUGATE_DATA,
                        mesh=chain_mesh(axis_name="particles", **CPU_MESH))


# ----------------------------------------------------------------------
# collectives in the hot loops
# ----------------------------------------------------------------------

@pytest.mark.parametrize("entry,some", [
    ("sample_chains_sharded", False), ("run_resident_hmc_sharded", False),
    ("run_resident_tempering_sharded", False), ("run_power_posterior_sharded", True),
    ("run_smc_sharded", True)])
def test_collectives_of_each_entry_point(group, entry, some):
    """Chains are independent: the three chain-sharded runners make no
    collective and no point-to-point call on either rank. The ladder
    exchanges edge rungs once a swap round (3 in 6 iterations, every 2) and
    SMC reduces and gathers every stage: the positive control."""
    _, ranks = group
    counts = [dict(zip(worker.COLLECTIVES, r[f"collectives_{entry}"].tolist())) for r in ranks]
    assert counts[0] == counts[1]
    if not some:
        assert not any(counts[0].values()), counts[0]
    elif entry == "run_power_posterior_sharded":
        assert counts[0] == {**dict.fromkeys(worker.COLLECTIVES, 0), "batch_isend_irecv": 3}
    else:
        # two stages, each 9 all-reduces (4 logsumexps, the acceptance) and 2 gathers
        assert counts[0] == {**dict.fromkeys(worker.COLLECTIVES, 0), "all_reduce": 18,
                             "all_gather": 4}
