"""One rank of the two-process Gloo group of tests/test_torch_parallel.py
(not a test module: the test spawns it twice).

It imports only ``torch``, numpy and the port, runs every sharded entry
point of ``eeyore_tpu_torch.parallel`` on this rank's block, in float64 on
the CPU, and writes what the rank got back to ``<out_dir>/rank<r>.npz``;
the pytest process, which gave the inputs in ``inputs.npz``, holds those
against the JAX package and against the unsharded port.

Usage: python tests/test_torch_parallel_worker.py <init file> <rank> <inputs.npz> <out_dir>
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch
import torch.distributed as dist

from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import (
    MLP,
    BayesianModel,
    DistributionModel,
    IIDNormalPrior,
    loss_functions,
    mlp,
)
from eeyore_tpu_torch.parallel import (
    chain_mesh,
    chain_sharding,
    global_log_ess,
    global_logsumexp,
    initialize_distributed,
    ladder_mesh,
    run_power_posterior_sharded,
    run_resident_hmc_sharded,
    run_resident_tempering_sharded,
    run_smc_sharded,
    sample_chains_sharded,
)
from eeyore_tpu_torch.parallel.sharded import _smc_stage
from eeyore_tpu_torch.samplers import MALA, PowerPosteriorSampler, SMCSampler

WORLD = 2
F64 = torch.float64
COV = np.array([[1.0, 0.5], [0.5, 1.0]])
EMPTY = (np.zeros((1, 0)), np.zeros((1, 0)))
# the sizes of each case; the pytest side reads them too
CHAINS_ITERS, CHAINS_BURNIN = 3000, 500
KERNEL_ITERS, KERNEL_BURNIN, KERNEL_SEED = 30, 10, 11
KERNEL_RUNS = {  # name: (runner keywords, chains, chain_block)
    "hmc": (dict(step=0.05, num_steps=10), 128, 64),
    "hmc_dense": (dict(step=0.05, num_steps=10, dense=True), 2048, 1024),
    "tempering": (dict(num_rungs=8, step=0.05, between_step=5), 128, 64),
    "tempering_dense": (dict(num_rungs=8, step=0.05, between_step=5, dense=True), 2048, 1024),
}
LADDER_EXACT_ITERS, LADDER_EXACT_BURNIN = 40, 10
LADDER_STEPS = {"MALA": {"step": 0.5}, "MetropolisHastings": {"scale": 0.8}}
COLD_ITERS, COLD_BURNIN, HOT_ITERS, HOT_BURNIN = 4000, 1000, 2000, 500
SMC_PARTICLES, STAGE_PARTICLES = 4096, 256
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "broadcast", "all_to_all", "all_to_all_single",
               "gather", "scatter", "reduce", "barrier", "send", "recv", "batch_isend_irecv",
               "all_gather_object", "broadcast_object_list")


def bvn_model():
    prec = torch.as_tensor(np.linalg.inv(COV))
    return DistributionModel(lambda t, x, y: -0.5 * torch.einsum("...i,ij,...j->...", t, prec, t),
                             num_params=2, dtype=torch.float64, device="cpu")


def xor_problem():
    xor = XYDataset.from_eeyore("xor")
    model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32, device="cpu",
                hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
    return model, xor.x, xor.y


class ConjugateNormal(BayesianModel):
    """theta ~ N(0, 1), y | theta ~ N(theta, 1) (tests/test_samplers.py::_ConjugateNormal)."""

    def __init__(self):
        super().__init__(loss=lambda pred, y: 0.5 * torch.sum((pred - y) ** 2, dim=(-2, -1)),
                         dtype=torch.float64, device="cpu")
        self.num_params = 1
        self.prior = IIDNormalPrior.standard(1, dtype=torch.float64, device="cpu")

    def forward(self, theta, x):
        return theta[..., None, :].expand(*theta.shape[:-1], x.shape[0], 1)


CONJUGATE_DATA = (np.zeros((1, 1)), np.ones((1, 1)))


def ladder(sampler, between_step):
    return PowerPosteriorSampler(bvn_model(), num_chains=8, sampler=sampler,
                                 sampler_kwargs=LADDER_STEPS[sampler], between_step=between_step,
                                 swap_scheme="even_odd")


def conjugate_smc(num_particles, betas=None):
    return SMCSampler(ConjugateNormal(), num_particles=num_particles, betas=betas,
                      mutation="MALA", mutation_step=0.5, num_mutation_steps=2)


def raised(call):
    """The message of the ValueError ``call`` raises ("" when it returns)."""
    try:
        call()
    except ValueError as err:
        return str(err)
    return ""


def case_meshes(inp):
    out = {}
    for name, mesh, axes in (("chain", chain_mesh(devices="cpu"), ("chains",)),
                             ("ladder12", ladder_mesh(1, 2, devices="cpu"), ("chains", "temp")),
                             ("ladder21", ladder_mesh(2, 1, devices="cpu"), ("chains", "temp"))):
        for axis in axes:
            sharding = chain_sharding(mesh, axis)
            rows = sharding.rows(8)
            out[f"mesh_{name}_{axis}"] = np.array([sharding.rank, sharding.size,
                                                   rows.start, rows.stop])
    return out


def case_collectives(inp):
    mesh = chain_mesh(devices="cpu")
    block = chain_sharding(mesh).shard(inp["lse_x"])
    return {"global_logsumexp": global_logsumexp(block, "chains", mesh).numpy(),
            "global_log_ess": global_log_ess(block, "chains", mesh).numpy()}


def case_chains(inp):
    recorded, state = sample_chains_sharded(
        MALA(bvn_model(), step=0.4), torch.Generator().manual_seed(int(inp["chains_seed"])),
        inp["bvn_theta0s"], EMPTY, CHAINS_ITERS, CHAINS_BURNIN, mesh=chain_mesh(devices="cpu"))
    return {f"chains_{k}": v.numpy() for k, v in recorded.items()} | {
        "chains_final": state.sample.numpy()}


def case_kernels(inp):
    model, x, y = xor_problem()
    mesh = chain_mesh(devices="cpu")
    out = {}
    for name, (kw, C, chain_block) in KERNEL_RUNS.items():
        runner = run_resident_tempering_sharded if "num_rungs" in kw else run_resident_hmc_sharded
        theta0s = inp[f"kernel_theta0s_{C}"]
        samples, final, counts = runner(model, x, y, KERNEL_SEED, theta0s, num_iters=KERNEL_ITERS,
                                        num_burnin_iters=KERNEL_BURNIN, chain_block=chain_block,
                                        mesh=mesh, **kw)
        out |= {f"kernel_{name}_samples": samples.numpy(), f"kernel_{name}_final": final.numpy(),
                f"kernel_{name}_counts": counts.numpy()}
        # 3 blocks do not divide over 2 ranks
        out[f"kernel_{name}_indivisible"] = np.array(raised(lambda: runner(
            model, x, y, KERNEL_SEED, np.concatenate([theta0s, theta0s[:chain_block]]),
            num_iters=KERNEL_ITERS, chain_block=chain_block, mesh=mesh, **kw)))
    return out


def case_ladders(inp):
    mesh = chain_mesh(axis_name="temp", devices="cpu")
    out = {}
    start = torch.tensor([2.0, 2.0], dtype=F64)
    for sampler in LADDER_STEPS:
        recorded = run_power_posterior_sharded(
            ladder(sampler, 2), torch.Generator().manual_seed(int(inp["ladder_seed"])), start,
            EMPTY, LADDER_EXACT_ITERS, LADDER_EXACT_BURNIN, mesh=mesh)
        out |= {f"ladder_{sampler}_{k}": v.numpy() for k, v in recorded.items()}
    cold = run_power_posterior_sharded(
        ladder("MALA", 5), torch.Generator().manual_seed(2), start, EMPTY, COLD_ITERS,
        COLD_BURNIN, mesh=mesh)
    hot = run_power_posterior_sharded(
        ladder("MALA", 2), torch.Generator().manual_seed(3), torch.zeros(2, dtype=F64), EMPTY,
        HOT_ITERS, HOT_BURNIN, mesh=mesh)
    return out | {"ladder_cold_run": cold["sample"].numpy(),
                  "ladder_hot_run": hot["sample"].numpy()}


def case_smc(inp):
    mesh = chain_mesh(axis_name="particles", devices="cpu")
    particles, log_w, diags = run_smc_sharded(conjugate_smc(SMC_PARTICLES),
                                              torch.Generator().manual_seed(0),
                                              CONJUGATE_DATA, mesh=mesh)
    out = {"smc_particles": particles.numpy(), "smc_log_w": log_w.numpy(),
           "smc_log_evidence": np.array(diags["log_evidence"])}
    out |= {f"smc_{k}": v.numpy() for k, v in diags.items() if k != "log_evidence"}
    # one stage on this rank's rows of the whole cloud's draws
    sharding = chain_sharding(mesh, "particles")
    rows = sharding.rows(STAGE_PARTICLES)
    smc = conjugate_smc(STAGE_PARTICLES)
    x, y = (torch.as_tensor(a) for a in CONJUGATE_DATA)
    for case in ("resampled", "kept"):
        particles, log_w, log_z, diag = _smc_stage(
            smc, torch.as_tensor(inp["stage_particles"][rows]),
            torch.as_tensor(inp[f"stage_log_w_{case}"][rows]), torch.tensor(-0.3, dtype=F64),
            torch.tensor(0.2, dtype=F64), torch.tensor(0.5, dtype=F64), x, y, sharding,
            u=torch.tensor(inp["stage_u"]), noise=torch.as_tensor(inp["stage_noise"][:, rows]),
            uniforms=torch.as_tensor(inp["stage_uniforms"][:, rows]))
        out |= {f"stage_{case}_particles": particles.numpy(),
                f"stage_{case}_log_w": log_w.numpy(), f"stage_{case}_log_z": log_z.numpy()}
        out |= {f"stage_{case}_{k}": v.numpy() for k, v in diag.items()}
    out["smc_indivisible"] = np.array(raised(lambda: run_smc_sharded(
        conjugate_smc(SMC_PARTICLES - 1), torch.Generator(), CONJUGATE_DATA, mesh=mesh)))
    return out


def case_collective_counts(inp):
    """The torch.distributed collectives and point-to-point calls each entry
    point makes (the counterpart of tests/test_sharding_hlo.py)."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    originals = {name: getattr(dist, name) for name in COLLECTIVES if hasattr(dist, name)}

    def counting(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return originals[name](*args, **kwargs)
        return call

    model, x, y = xor_problem()
    chain, temp = chain_mesh(devices="cpu"), chain_mesh(axis_name="temp", devices="cpu")
    particles = chain_mesh(axis_name="particles", devices="cpu")
    theta0s = inp["kernel_theta0s_128"]
    calls = {
        "sample_chains_sharded": lambda: sample_chains_sharded(
            MALA(bvn_model(), step=0.4), torch.Generator(), inp["bvn_theta0s"], EMPTY, 20, 5,
            mesh=chain),
        "run_resident_hmc_sharded": lambda: run_resident_hmc_sharded(
            model, x, y, 1, theta0s, 0.05, 10, 4, chain_block=64, mesh=chain),
        "run_resident_tempering_sharded": lambda: run_resident_tempering_sharded(
            model, x, y, 1, theta0s, 8, 0.05, between_step=2, num_iters=4, chain_block=64,
            mesh=chain),
        "run_power_posterior_sharded": lambda: run_power_posterior_sharded(
            ladder("MALA", 2), torch.Generator(), torch.zeros(2, dtype=F64), EMPTY, 6, 0,
            mesh=temp),
        "run_smc_sharded": lambda: run_smc_sharded(
            conjugate_smc(64, betas=[0.0, 0.5, 1.0]), torch.Generator(), CONJUGATE_DATA,
            mesh=particles),
    }
    out = {}
    for name, call in calls.items():
        for k in counts:
            counts[k] = 0
        for k in originals:
            setattr(dist, k, counting(k))
        try:
            call()
        finally:
            for k, f in originals.items():
                setattr(dist, k, f)
        out[f"collectives_{name}"] = np.array([counts[k] for k in COLLECTIVES])
    return out


CASES = (case_meshes, case_collectives, case_chains, case_kernels, case_ladders, case_smc,
         case_collective_counts)


def main():
    init_file, rank, inputs, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    initialize_distributed(f"file://{init_file}", WORLD, rank, device="cpu")
    inp = dict(np.load(inputs))
    results = {}
    for case in CASES:
        results |= case(inp)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **results)
    dist.destroy_process_group()
    print(f"[rank {rank}] done", flush=True)


if __name__ == "__main__":
    main()
