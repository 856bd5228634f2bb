"""Probe of the lane kernels' settings on a CUDA card: config 4's staged Gibbs
move (iris MLP(4,3,2,3), ``Gibbs(scales=0.1)``), the staged iris NUTS kernel
(MLP(4,3,3), depth 3, tuned), the staged HMC kernel at config 3's shape
(MLP(4,3,3), ``HMC(tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64)``,
tuned in groups of 256) and the staged iris MH (scale 0.1) and MALA (step
0.003) moves, each built at the modules' settings and at the other lanes a
chain and occupancy targets of ``SWEEP``, held against its plain version and
timed at its main path's shape; and the staged ladder move (iris MLP(4,3,3),
ladders of 8 rungs at (i/8)^4, MALA step 0.003 and MH scale 0.1, swaps every
10 iterations), timed at two shapes: its entry point's one chain block of 128
chains (``PowerPosteriorSampler.run(backend="auto")``), where the one chain's
serial row loop is the time, and 32768 chains in chain blocks of 4096; and
the dense XOR NUTS kernel (MLP(2,2,1), ``HMCDATuner(d=0.8)``, one thread a
chain) at the register caps of ``NUTS_DENSE_SWEEP``, at the three XOR
NUTS main shapes: depth 3, step 0.1; the auto path's depth 2 at its probed
step; and depth 2 at the probed step and frozen metric of the auto path with
``mass_adapt`` (the plans of ``chip_smoke.py``'s phase 15, PERF.md), each
in the tuning group that dispatch gives the build (JAX's 8192 chains where
the card holds it); the dense MH, MALA and ladder moves (``walk_dense``) on
XOR at ``WALK_DENSE_SWEEP``'s lanes a chain and occupancy targets, at
BASELINE.md config 1 (MH scale 0.1, MLP(2,2,1)) and config 2 (MALA step
0.01, MLP(2,3,2,1)), 32768 chains x 2048 iterations, 1024 burn-in, in chain
blocks of 8192, and the XOR ladder (MLP(2,2,1), 8 rungs at (i/8)^4, MALA step
0.05, swaps every 10) at its entry point's 1024 chains and at 32768; and the
SMC mutation pass (``smc``) on iris MLP(4,3,3) at ``SMC_SWEEP``'s lanes a
particle and occupancy targets, MALA step 0.003 and MH step 0.01, 16384
prior draws x 5 steps at beta 0.3.

Run from the root of the repository on a machine with a card:

    python3 scripts/lane_sweep.py [--seed 0]
        [--kernels gibbs,nuts,hmc,walk,tempering,nuts_dense,walk_dense,smc]

It prints the card's name and power limit, then one JSON line per build and
move: the lanes a chain, the blocks an SM must hold (which caps the
registers), the build's registers and local bytes, the launch (blocks, the
card's occupancy, SMs covered), the share of chains that agree with the plain
version (Gibbs: every unit split, 32768 chains x 20 iterations, extras; NUTS:
untuned, 16384 chains x 5 iterations; HMC: untuned, 4096 chains x 20
iterations of 8 leapfrog steps, extras, and tuned over a 5-iteration burn-in;
MH and MALA: 4096 chains x 20 iterations, extras; the ladder move: 4096 chains
x 20 iterations in chain blocks of 128, swaps every 5, extras, both count
columns, with the plain version's closest accept test in float64 in the
ladders of the chains that disagree: ``ladder_witness``) and the kernel's time
at the main path's shape (Gibbs, MH and MALA: 32768 chains x 2048 iterations,
1024 burn-in; NUTS: 16384 chains x 2048 iterations, 1024 burn-in, tuning
groups of 256; HMC: 32768 chains x 1500 iterations, 500 burn-in, the plan
dispatch gives ``sample_chains``; the ladder move: 128 chains and 32768 chains
x 2048 iterations, 1024 burn-in; dense NUTS: 32768 chains x 2048 iterations,
1024 burn-in), the median of three launches after a warm-up; dense NUTS is
held against its plain version untuned (16384 chains x 5 iterations) and tuned
(3 burn-in iterations) at each shape; the dense walks against theirs on 4096
chains x 20 iterations, extras (the ladder in a chain block of 1024, swaps
every 5, with ``ladder_witness``); the SMC pass on its 16384 particles
(final theta, pot and counts). The modules' settings
(``resident_walk.GIBBS_LANES`` and ``GIBBS_MIN_BLOCKS``,
``resident_nuts.NUTS_LANES`` and ``NUTS_MIN_BLOCKS``,
``resident_hmc.HMC_LANES`` and ``HMC_MIN_BLOCKS``,
``resident_walk.WALK_LANES`` and ``WALK_MIN_BLOCKS``,
``resident_walk.TEMPERING_LANES`` and ``TEMPERING_MIN_BLOCKS``,
``resident_nuts_dense.NUTS_DENSE_BOUND``,
``resident_walk_dense.WALK_DENSE_LANES`` and ``WALK_DENSE_MIN_BLOCKS``,
``resident_smc.SMC_LANES`` and ``SMC_MIN_BLOCKS``) are the fastest of such a run; this
script sets them in its own process only, build by build. It exits non-zero
when a build disagrees with its plain version.
"""

import argparse
import concurrent.futures
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    NUTS_ATOL,
    NUTS_MIN_AGREEING,
    NUTS_RTOL,
    RESIDENT_LANE_MIN_AGREEING,
    RESIDENT_MIN_AGREEING,
    card_line,
    chain_agreement,
    event_times,
)

# (kernel, lanes a chain, blocks an SM must hold); the modules' own settings
# are measured too. Lanes 1 is one thread a chain, built without launch
# bounds (the parent's layout of HMC, MH and MALA).
SWEEP = (("gibbs", 32, 1), ("gibbs", 32, 2), ("gibbs", 16, 2), ("gibbs", 8, 2),
         ("nuts", 8, 4), ("nuts", 8, 6), ("nuts", 16, 2), ("nuts", 32, 1),
         ("hmc", 1, 1), ("hmc", 2, 1), ("hmc", 4, 1), ("hmc", 8, 2), ("hmc", 8, 4),
         ("walk", 1, 1), ("walk", 2, 2), ("walk", 2, 4), ("walk", 4, 2), ("walk", 4, 3),
         ("walk", 4, 4), ("walk", 8, 2), ("walk", 8, 4),
         ("tempering", 1, 1), ("tempering", 2, 2), ("tempering", 2, 4), ("tempering", 4, 2),
         ("tempering", 4, 4), ("tempering", 8, 1), ("tempering", 8, 2), ("tempering", 8, 4))
# dense NUTS, one thread a chain: the launch bound's threads a block (0:
# none), which caps the registers
NUTS_DENSE_SWEEP = tuple(("nuts_dense", 1, bound) for bound in (0, 512, 1024))
# the dense walks on XOR (at most 4 lanes: 4 rows) and the SMC pass on iris
WALK_DENSE_SWEEP = (("walk_dense", 1, 1), ("walk_dense", 2, 2), ("walk_dense", 2, 3),
                    ("walk_dense", 2, 4), ("walk_dense", 4, 2), ("walk_dense", 4, 3),
                    ("walk_dense", 4, 4))
SMC_SWEEP = (("smc", 1, 1), ("smc", 4, 2), ("smc", 4, 3), ("smc", 4, 4), ("smc", 8, 1),
             ("smc", 8, 2), ("smc", 8, 3))
KERNELS = ("gibbs", "nuts", "hmc", "walk", "tempering", "nuts_dense", "walk_dense", "smc")
# node sub-blocks that split every unit of iris MLP(4,3,2,3)
SPLIT_UNITS = [3, 3, 3, 2, 2, 2, 2, 2]
C_GIBBS, C_NUTS, ITERS, BURNIN, NUTS_DEPTH = 32768, 16384, 2048, 1024, 3
C_HMC, HMC_ITERS, HMC_BURNIN, HMC_BLOCK = 32768, 1500, 500, 256
C_CHECK, WALK_BLOCK = 4096, 4096
# the ladder move: rungs, swap period, the entry point's chain block (one
# block of ladders), the chain block at size, the check's swap period
RUNGS, BETWEEN, LADDER_BLOCK, LADDER_SIZE_BLOCK, CHECK_BETWEEN = 8, 10, 128, 4096, 5
# the ladder check's witness: accept tests closer than this to their
# threshold, about a float32 rounding of a log-target of order 100
WITNESS_MARGIN = 1e-5
# dense NUTS's main shapes: (name, depth, step, metric); the auto paths' steps
# and metric as their probes found them (PERF.md, section 5)
AUTO_METRIC = (0.8042, 0.8197, 1.0268, 0.8828, 0.8898, 0.8264, 0.7177, 0.6989, 0.5551)
NUTS_DENSE_SHAPES = (("depth_3", 3, 0.1, None), ("auto_depth_2", 2, 0.66, None),
                     ("auto_depth_2_mass_adapt", 2, 0.794, AUTO_METRIC))
C_NUTS_DENSE, DENSE_GROUPS = 32768, (8192, 4096, 2048, 1024)
# the dense walks' main chain block, the XOR ladder's entry point (one chain
# block), the SMC pass's particles, steps and temperature
WALK_DENSE_BLOCK, XOR_LADDER_BLOCK, C_SMC, SMC_STEPS, SMC_BETA = 8192, 1024, 16384, 5, 0.3


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help="comma-separated subset of " + ",".join(KERNELS))
    args = parser.parse_args(argv)
    kernels = tuple(k for k in args.kernels.split(",") if k)
    if not set(kernels) <= set(KERNELS):
        parser.error(f"--kernels takes {KERNELS}, got {kernels}")
    if not torch.cuda.is_available():
        print("lane_sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from eeyore_tpu_torch.datasets import XYDataset
    from eeyore_tpu_torch.models import MLP, loss_functions, mlp
    from eeyore_tpu_torch.ops import (
        _build,
        resident_hmc,
        resident_nuts,
        resident_nuts_dense,
        resident_smc,
        resident_walk,
        resident_walk_dense,
    )
    from eeyore_tpu_torch.ops.fused_mlp import arch_defines
    from eeyore_tpu_torch.ops.mlp_math import prepare_data
    from eeyore_tpu_torch.ops.resident_tempering import make_resident_tempering
    from eeyore_tpu_torch.ops.resident_tempering_dense import make_resident_tempering_dense
    from eeyore_tpu_torch.samplers import HMC
    from eeyore_tpu_torch.samplers.dispatch import resolve_backend
    from eeyore_tpu_torch.tuners import HMCDATuner

    device = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(args.seed)
    iris = XYDataset.from_eeyore("iris", yonehot=True)

    def make_model(dims, activations):
        return MLP(loss=loss_functions["multiclass_classification"], dtype=torch.float32,
                   device=device, hparams=mlp.Hyperparameters(dims=dims, activations=activations))

    gibbs_model = make_model([4, 3, 2, 3], [mlp.sigmoid, mlp.sigmoid, None])
    nuts_model = make_model([4, 3, 3], [mlp.sigmoid, None])
    xor = XYDataset.from_eeyore("xor")
    xor_model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                    device=device, hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
    xor2321_model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                        device=device, hparams=mlp.Hyperparameters(dims=[2, 3, 2, 1]))
    n_rows = prepare_data(gibbs_model, iris.x, iris.y)[0].shape[0]
    settings = {"gibbs": (resident_walk.GIBBS_LANES, resident_walk.GIBBS_MIN_BLOCKS),
                "nuts": (resident_nuts.NUTS_LANES, resident_nuts.NUTS_MIN_BLOCKS),
                "hmc": (resident_hmc.HMC_LANES, resident_hmc.HMC_MIN_BLOCKS),
                "walk": (resident_walk.WALK_LANES, resident_walk.WALK_MIN_BLOCKS),
                "tempering": (resident_walk.TEMPERING_LANES, resident_walk.TEMPERING_MIN_BLOCKS),
                "nuts_dense": (1, resident_nuts_dense.NUTS_DENSE_BOUND),
                "smc": (resident_smc.SMC_LANES, resident_smc.SMC_MIN_BLOCKS)}
    dense_settings = dict(resident_walk_dense.WALK_DENSE_LANES)
    # lanes None: the module's lanes of each dense move
    settings["walk_dense"] = (None, resident_walk_dense.WALK_DENSE_MIN_BLOCKS)
    # the dense walks' runs cover every lane count, the settings' among them
    runs = [(kernel, *settings[kernel]) for kernel in kernels if kernel != "walk_dense"]
    runs += [run for run in SWEEP + NUTS_DENSE_SWEEP + WALK_DENSE_SWEEP + SMC_SWEEP
             if run[0] in kernels and run not in runs]

    def use(kernel, lanes, min_blocks):
        if kernel == "gibbs":
            resident_walk.GIBBS_LANES, resident_walk.GIBBS_MIN_BLOCKS = lanes, min_blocks
        elif kernel == "nuts":
            resident_nuts.NUTS_LANES, resident_nuts.NUTS_MIN_BLOCKS = lanes, min_blocks
        elif kernel == "hmc":
            resident_hmc.HMC_LANES, resident_hmc.HMC_MIN_BLOCKS = lanes, min_blocks
        elif kernel == "walk":
            resident_walk.WALK_LANES, resident_walk.WALK_MIN_BLOCKS = lanes, min_blocks
        elif kernel == "tempering":
            resident_walk.TEMPERING_LANES, resident_walk.TEMPERING_MIN_BLOCKS = lanes, min_blocks
        elif kernel == "walk_dense":
            resident_walk_dense.WALK_DENSE_LANES = (
                dense_settings if lanes is None else dict.fromkeys(dense_settings, lanes))
            resident_walk_dense.WALK_DENSE_MIN_BLOCKS = min_blocks
        elif kernel == "smc":
            resident_smc.SMC_LANES, resident_smc.SMC_MIN_BLOCKS = lanes, min_blocks
        else:  # min_blocks: the launch bound's threads
            resident_nuts_dense.NUTS_DENSE_BOUND = min_blocks

    # every build at once, under the names the makers load them by: the
    # settings go into the generated header or the defines before any build
    builds = []
    for kernel, lanes, min_blocks in runs:
        use(kernel, lanes, min_blocks)
        if kernel == "gibbs":
            for subs in (None, SPLIT_UNITS):
                builds.append(resident_walk.library_spec(gibbs_model, subs, n_rows))
        elif kernel == "nuts":
            tag, defines = arch_defines(nuts_model)
            builds.append((f"{resident_nuts.KERNEL}_{tag}_d{NUTS_DEPTH}_l{lanes}_b{min_blocks}",
                           "resident_nuts.cu", tuple(defines) + (
                               f"NUTS_DEPTH={NUTS_DEPTH}", f"NUTS_LANES={lanes}",
                               f"NUTS_MIN_BLOCKS={min_blocks}"), None))
        elif kernel == "hmc":
            builds.append(resident_hmc.library_spec(nuts_model, lanes) + (None,))
        elif kernel == "walk":
            builds.append(resident_walk.library_spec(nuts_model, lanes=lanes))
        elif kernel == "tempering":
            builds.append(resident_walk.library_spec(nuts_model, ladder_lanes=lanes))
        elif kernel == "walk_dense":
            for model in (xor_model, xor2321_model):
                builds.append(resident_walk_dense.library_spec(model, xor.x, xor.y, lanes=lanes))
        elif kernel == "smc":
            builds.append(resident_smc.library_spec(nuts_model, lanes) + (None,))
        else:
            for _, depth, _, metric in NUTS_DENSE_SHAPES:
                builds.append(resident_nuts_dense.library_spec(xor_model, xor.x, xor.y, depth,
                                                               metric))
        use(kernel, *settings[kernel])
    with concurrent.futures.ThreadPoolExecutor(min(len(builds), 12)) as pool:
        for future in [pool.submit(_build.load_library, *b) for b in builds]:
            future.result()

    print(card_line(), flush=True)
    theta0s = {
        "gibbs": torch.as_tensor(0.1 * rng.normal(size=(C_GIBBS, gibbs_model.num_params)),
                                 dtype=torch.float32, device=device),
        "nuts": torch.as_tensor(0.1 * rng.normal(size=(C_NUTS, nuts_model.num_params)),
                                dtype=torch.float32, device=device),
        "iris433": torch.as_tensor(0.1 * rng.normal(size=(C_HMC, nuts_model.num_params)),
                                   dtype=torch.float32, device=device),
        "xor": torch.as_tensor(rng.normal(size=(C_NUTS_DENSE, xor_model.num_params)),
                               dtype=torch.float32, device=device),
        "xor_walk": torch.as_tensor(0.1 * rng.normal(size=(C_HMC, xor_model.num_params)),
                                    dtype=torch.float32, device=device),
        "xor2321_walk": torch.as_tensor(0.1 * rng.normal(size=(C_HMC, xor2321_model.num_params)),
                                        dtype=torch.float32, device=device),
        "smc": nuts_model.prior.sample(torch.Generator(device=device).manual_seed(args.seed),
                                       (C_SMC,))}
    hmc_tuned = dict(step=0.1, num_steps=10, tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64)
    ok = True

    def agreement(held, theta, limit, chain_dims, tol=None, rungs=None):
        agree = None
        for got, want, chain_dim in zip(held(args.seed, theta), held.plain(args.seed, theta)[0],
                                        chain_dims):
            chains_ok = chain_agreement(got, want, chain_dim, **(tol or {}))[0]
            agree = chains_ok if agree is None else agree & chains_ok
        share = agree.float().mean().item()
        out = {"share_agreeing_with_plain": share, "limit": limit, "ok": share >= limit}
        if rungs is not None:
            out.update(ladder_witness(held, theta, agree, rungs))
        return out

    def ladder_witness(held, theta, agree, rungs):
        """Where a ladder's chains disagree with the plain version: which,
        and the closest accept test (smallest |log rate - log u|, within-rung
        or swap) of their ladders in the plain version run in float64, and
        how many of all its tests lie within ``WITNESS_MARGIN``. A test a
        float32 rounding away from its threshold can go either way; after it,
        the ladder's swaps carry the difference to the other rungs."""
        bad = torch.nonzero(~agree).flatten()
        margins = []
        held.plain(args.seed, theta, dtype=torch.float64, margins=margins)
        margins = torch.stack(margins)  # [iterations, C]
        ladders = torch.unique(bad // rungs)
        closest = margins.view(margins.shape[0], -1, rungs)[:, ladders]
        return {"disagreeing_chains": bad.tolist(),
                "their_ladders_closest_test_f64": closest.min().item() if len(bad) else None,
                "tests_within_margin_f64": int((margins < WITNESS_MARGIN).sum()),
                "witness_margin": WITNESS_MARGIN}

    def report(record, fn, theta, checks):
        nonlocal ok
        ms, ms_runs = event_times(lambda: fn(args.seed, theta))
        ok = ok and all(c["ok"] for c in checks.values())
        print(json.dumps(dict(record, ms=ms, ms_runs=ms_runs, checks=checks)), flush=True)

    for kernel, lanes, min_blocks in runs:
        use(kernel, lanes, min_blocks)
        record = {"kernel": kernel, "lanes": lanes, "min_blocks": min_blocks,
                  "settings": (lanes, min_blocks) == settings[kernel]}
        if kernel == "nuts_dense":
            record.update(min_blocks=None, bound=min_blocks)
            for shape, depth, step, metric in NUTS_DENSE_SHAPES:
                lib = resident_nuts_dense.load_kernel(xor_model, xor.x, xor.y, depth, metric)
                group = None
                for cb in DENSE_GROUPS:  # dispatch's choice: the largest the card holds
                    try:
                        resident_nuts_dense.group_shape(lib, cb)
                    except ValueError:
                        continue
                    group = cb
                    break
                if group is None:
                    print(json.dumps(dict(record, shape=shape, group=None)), flush=True)
                    continue

                def dense(iters, burnin, tuned=True, C=C_NUTS_DENSE):
                    return resident_nuts_dense.make_resident_nuts_dense(
                        xor_model, xor.x, xor.y, step, depth, iters, burnin, chain_block=group,
                        tuner=HMCDATuner(d=0.8) if tuned else None, inv_mass=metric,
                        device=device), theta0s["xor"][:C]

                tol = dict(atol=NUTS_ATOL, rtol=NUTS_RTOL)
                checks = {}
                for check_name, (held, theta) in (("untuned", dense(5, 0, False, C_NUTS)),
                                                  ("tuned_burnin_3", dense(5, 3, True, C_NUTS))):
                    checks[check_name] = agreement(held, theta, NUTS_MIN_AGREEING, (1, 0, 0, 0),
                                                   tol)
                fn, theta = dense(ITERS, BURNIN)
                fn(args.seed, theta)
                info = resident_nuts_dense.last_info[resident_nuts_dense.KERNEL]
                accept_stat = (info["accept_sums"].sum() / (theta.shape[0] * (ITERS - BURNIN)))
                report(dict(record, shape=shape, depth=depth, step=step, chain_block=group,
                            resources=resident_nuts_dense.kernel_resources(lib),
                            launch=fn.launch_shape, chains=theta.shape[0], iterations=ITERS,
                            burnin=BURNIN, accept_stat=accept_stat.item()), fn, theta, checks)
                del fn
        elif kernel == "walk_dense":
            for move, model, maker, value, theta in (
                    ("mh", xor_model, resident_walk_dense.make_resident_mh_dense, 0.1,
                     theta0s["xor_walk"]),
                    ("mala", xor2321_model, resident_walk_dense.make_resident_mala_dense, 0.01,
                     theta0s["xor2321_walk"])):
                fn = maker(model, xor.x, xor.y, value, ITERS, BURNIN, chain_block=WALK_DENSE_BLOCK,
                           device=device)
                held = maker(model, xor.x, xor.y, value, 20, chain_block=C_CHECK,
                             record_extras=True, device=device)
                lib = resident_walk_dense.load_kernel(model, xor.x, xor.y, lanes=lanes)
                checks = {"untuned": agreement(held, theta[:C_CHECK], RESIDENT_LANE_MIN_AGREEING,
                                               (1, 0, 0, 1, 1))}
                report(dict(record, kernel=f"walk_dense_{move}",
                            settings=(lanes, min_blocks) == (dense_settings[move],
                                                             settings[kernel][1]),
                            resources=resident_walk_dense.kernel_resources(lib, move),
                            launch=fn.walk_launch(C_HMC, sm_count), chains=C_HMC,
                            chain_block=WALK_DENSE_BLOCK, iterations=ITERS, burnin=BURNIN),
                       fn, theta, checks)
                del fn, held
            temps = (np.arange(1, RUNGS + 1) / RUNGS) ** 4

            def dense_ladder(iters, burnin, between=BETWEEN, extras=False):
                return make_resident_tempering_dense(
                    xor_model, xor.x, xor.y, RUNGS, 0.05, "MALA", temps, between, iters, burnin,
                    XOR_LADDER_BLOCK, record_extras=extras, device=device)

            lib = resident_walk_dense.load_kernel(xor_model, xor.x, xor.y, lanes=lanes)
            checks = {"untuned": agreement(dense_ladder(20, 0, CHECK_BETWEEN, True),
                                           theta0s["xor_walk"][:C_CHECK],
                                           RESIDENT_LANE_MIN_AGREEING, (1, 0, 0, 1, 1),
                                           rungs=RUNGS)}
            fn = dense_ladder(ITERS, BURNIN)
            for C in (XOR_LADDER_BLOCK, C_HMC):
                report(dict(record, kernel="walk_dense_tempering_mala",
                            settings=(lanes, min_blocks) == (dense_settings["ladder"],
                                                             settings[kernel][1]),
                            resources=resident_walk_dense.kernel_resources(lib, "tempering_mala"),
                            launch=fn.tempering_launch(C), chains=C,
                            chain_block=XOR_LADDER_BLOCK, iterations=ITERS, burnin=BURNIN,
                            rungs=RUNGS, between_step=BETWEEN),
                       fn, theta0s["xor_walk"][:C], checks)
            del fn
        elif kernel == "smc":
            lib = resident_smc.load_kernel(nuts_model, lanes)
            for mutation, step in (("MALA", 0.003), ("MH", 0.01)):
                fn = resident_smc.make_resident_smc_mutation(
                    nuts_model, iris.x, iris.y, step, SMC_STEPS, chain_block=1024,
                    mutation=mutation, device=device)
                theta = theta0s["smc"]
                agree = None
                for got, want in zip(fn(args.seed, SMC_BETA, theta),
                                     fn.plain(args.seed, SMC_BETA, theta)[0]):
                    chains_ok = chain_agreement(got, want, 0)[0]
                    agree = chains_ok if agree is None else agree & chains_ok
                share = agree.float().mean().item()
                checks = {"untuned": {"share_agreeing_with_plain": share,
                                      "limit": RESIDENT_MIN_AGREEING,
                                      "ok": share >= RESIDENT_MIN_AGREEING}}
                ms, ms_runs = event_times(lambda: fn(args.seed, SMC_BETA, theta))
                ok = ok and checks["untuned"]["ok"]
                print(json.dumps(dict(
                    record, kernel=f"smc_{mutation.lower()}",
                    resources=resident_smc.kernel_resources(lib, mutation),
                    launch=fn.smc_launch(C_SMC, sm_count), particles=C_SMC, steps=SMC_STEPS,
                    beta=SMC_BETA, ms=ms, ms_runs=ms_runs, checks=checks)), flush=True)
                del fn
        elif kernel == "gibbs":
            fn = resident_walk.make_resident_gibbs(
                gibbs_model, iris.x, iris.y, 0.1, None, num_iters=ITERS,
                num_burnin_iters=BURNIN, chain_block=4096, device=device)
            held = resident_walk.make_resident_gibbs(
                gibbs_model, iris.x, iris.y, 0.1, SPLIT_UNITS, num_iters=20, chain_block=4096,
                record_extras=True, device=device)
            resources = resident_walk.kernel_resources(
                resident_walk.load_kernel(gibbs_model, None, n_rows), "gibbs")
            checks = {"split_units": agreement(held, theta0s["gibbs"], RESIDENT_MIN_AGREEING,
                                               (1, 0, 0, 1, 1))}
            report(dict(record, resources=resources, launch=fn.gibbs_launch(C_GIBBS, sm_count),
                        chains=C_GIBBS, iterations=ITERS, burnin=BURNIN),
                   fn, theta0s["gibbs"], checks)
        elif kernel == "nuts":
            fn = resident_nuts.make_resident_nuts(
                nuts_model, iris.x, iris.y, 0.02, NUTS_DEPTH, ITERS, BURNIN, chain_block=256,
                tuner=HMCDATuner(d=0.8), device=device)
            held = resident_nuts.make_resident_nuts(
                nuts_model, iris.x, iris.y, 0.02, NUTS_DEPTH, 5, chain_block=256, device=device)
            resources = resident_nuts.kernel_resources(
                resident_nuts.load_kernel(nuts_model, NUTS_DEPTH, lanes))
            checks = {"untuned": agreement(held, theta0s["nuts"], NUTS_MIN_AGREEING,
                                           (1, 0, 0, 0), dict(atol=NUTS_ATOL, rtol=NUTS_RTOL))}
            report(dict(record, resources=resources, launch=fn.nuts_launch(C_NUTS, sm_count),
                        chains=C_NUTS, iterations=ITERS, burnin=BURNIN),
                   fn, theta0s["nuts"], checks)
        elif kernel == "hmc":
            plan, reason = resolve_backend(
                HMC(nuts_model, tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64),
                (iris.x, iris.y), C_HMC, HMC_ITERS, HMC_BURNIN, platform="cuda")
            if plan is None or plan.chain_block != HMC_BLOCK:
                raise RuntimeError(f"config 3's plan: {plan and plan.chain_block} ({reason})")
            fn = plan.maker(nuts_model, iris.x, iris.y, device=device, **plan.kwargs)
            check_theta = theta0s["iris433"][:C_CHECK]
            untuned = resident_hmc.make_resident_hmc(
                nuts_model, iris.x, iris.y, 0.02, 8, 20, chain_block=HMC_BLOCK,
                record_extras=True, device=device)
            tuned = resident_hmc.make_resident_hmc(
                nuts_model, iris.x, iris.y, num_iters=10, num_burnin_iters=5,
                chain_block=HMC_BLOCK, device=device, **hmc_tuned)
            resources = resident_hmc.kernel_resources(resident_hmc.load_kernel(nuts_model, lanes))
            checks = {"untuned": agreement(untuned, check_theta, RESIDENT_LANE_MIN_AGREEING,
                                           (1, 0, 0, 1, 1)),
                      "tuned_burnin_5": agreement(tuned, check_theta, RESIDENT_MIN_AGREEING,
                                                  (1, 0, 0))}
            report(dict(record, resources=resources,
                        launch=fn.hmc_launch(C_HMC, sm_count), chains=C_HMC,
                        iterations=HMC_ITERS, burnin=HMC_BURNIN, chain_block=plan.chain_block),
                   fn, theta0s["iris433"], checks)
        elif kernel == "tempering":
            temps = (np.arange(1, RUNGS + 1) / RUNGS) ** 4
            for move, sampler, value in (("mh", "MetropolisHastings", 0.1),
                                         ("mala", "MALA", 0.003)):
                def ladder(C, chain_block, iters, burnin, between=BETWEEN, extras=False):
                    fn = make_resident_tempering(
                        nuts_model, iris.x, iris.y, RUNGS, value, sampler, temps, between,
                        iters, burnin, chain_block, record_extras=extras, device=device)
                    return fn, theta0s["iris433"][:C]

                held, check_theta = ladder(C_CHECK, LADDER_BLOCK, 20, 0, CHECK_BETWEEN, True)
                check_lanes = resident_walk.tempering_lanes(n_rows, RUNGS, LADDER_BLOCK)
                resources = resident_walk.kernel_resources(
                    resident_walk.load_kernel(nuts_model, ladder_lanes=check_lanes),
                    f"tempering_{move}")
                checks = {"untuned": agreement(held, check_theta, RESIDENT_LANE_MIN_AGREEING,
                                               (1, 0, 0, 1, 1), rungs=RUNGS)}
                for C, chain_block in ((LADDER_BLOCK, LADDER_BLOCK),
                                       (C_HMC, LADDER_SIZE_BLOCK)):
                    fn, theta = ladder(C, chain_block, ITERS, BURNIN)
                    report(dict(record, kernel=f"tempering_{move}", resources=resources,
                                launch=fn.tempering_launch(C), chains=C, chain_block=chain_block,
                                iterations=ITERS, burnin=BURNIN, rungs=RUNGS,
                                between_step=BETWEEN), fn, theta, checks)
                    del fn
                del held
        else:
            for move, maker, value in (("mh", resident_walk.make_resident_mh, 0.1),
                                       ("mala", resident_walk.make_resident_mala, 0.003)):
                fn = maker(nuts_model, iris.x, iris.y, value, ITERS, BURNIN,
                           chain_block=WALK_BLOCK, device=device)
                held = maker(nuts_model, iris.x, iris.y, value, 20, chain_block=WALK_BLOCK,
                             record_extras=True, device=device)
                resources = resident_walk.kernel_resources(
                    resident_walk.load_kernel(nuts_model, lanes=lanes), move)
                checks = {"untuned": agreement(held, theta0s["iris433"][:C_CHECK],
                                               RESIDENT_LANE_MIN_AGREEING, (1, 0, 0, 1, 1))}
                report(dict(record, kernel=f"walk_{move}", resources=resources,
                            launch=fn.walk_launch(C_HMC, sm_count), chains=C_HMC,
                            iterations=ITERS, burnin=BURNIN),
                       fn, theta0s["iris433"], checks)
                del fn, held
        use(kernel, *settings[kernel])
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
