"""Probe of the lane kernels' settings on a CUDA card: config 4's staged Gibbs
move (iris MLP(4,3,2,3), ``Gibbs(scales=0.1)``), the staged iris NUTS kernel
(MLP(4,3,3), depth 3, tuned), the staged HMC kernel at config 3's shape
(MLP(4,3,3), ``HMC(tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64)``,
tuned in groups of 256) and the staged iris MH (scale 0.1) and MALA (step
0.003) moves, each built at the modules' settings and at the other lanes a
chain and occupancy targets of ``SWEEP``, held against its plain version and
timed at its main path's shape.

Run from the root of the repository on a machine with a card:

    python3 scripts/lane_sweep.py [--seed 0] [--kernels gibbs,nuts,hmc,walk]

It prints the card's name and power limit, then one JSON line per build and
move: the lanes a chain, the blocks an SM must hold (which caps the
registers), the build's registers and local bytes, the launch (blocks, the
card's occupancy, SMs covered), the share of chains that agree with the plain
version (Gibbs: every unit split, 32768 chains x 20 iterations, extras;
NUTS: untuned, 16384 chains x 5 iterations; HMC: untuned, 4096 chains x 20
iterations of 8 leapfrog steps, extras, and tuned over a 5-iteration burn-in;
MH and MALA: 4096 chains x 20 iterations, extras) and the kernel's time at
the main path's shape (Gibbs, MH and MALA: 32768 chains x 2048 iterations,
1024 burn-in; NUTS: 16384 chains x 2048 iterations, 1024 burn-in, tuning
groups of 256; HMC: 32768 chains x 1500 iterations, 500 burn-in, the plan
dispatch gives ``sample_chains``), the median of three launches after a
warm-up. The modules' settings (``resident_walk.GIBBS_LANES`` and
``GIBBS_MIN_BLOCKS``, ``resident_nuts.NUTS_LANES`` and ``NUTS_MIN_BLOCKS``,
``resident_hmc.HMC_LANES`` and ``HMC_MIN_BLOCKS``, ``resident_walk.WALK_LANES``
and ``WALK_MIN_BLOCKS``) are the fastest of such a run; this script sets them
in its own process only, build by build. It exits non-zero when a build
disagrees with its plain version.
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
         ("walk", 4, 4), ("walk", 8, 2), ("walk", 8, 4))
KERNELS = ("gibbs", "nuts", "hmc", "walk")
# node sub-blocks that split every unit of iris MLP(4,3,2,3)
SPLIT_UNITS = [3, 3, 3, 2, 2, 2, 2, 2]
C_GIBBS, C_NUTS, ITERS, BURNIN, NUTS_DEPTH = 32768, 16384, 2048, 1024, 3
C_HMC, HMC_ITERS, HMC_BURNIN, HMC_BLOCK = 32768, 1500, 500, 256
C_CHECK, WALK_BLOCK = 4096, 4096


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
    from eeyore_tpu_torch.ops import _build, resident_hmc, resident_nuts, resident_walk
    from eeyore_tpu_torch.ops.fused_mlp import arch_defines
    from eeyore_tpu_torch.ops.mlp_math import prepare_data
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
    n_rows = prepare_data(gibbs_model, iris.x, iris.y)[0].shape[0]
    settings = {"gibbs": (resident_walk.GIBBS_LANES, resident_walk.GIBBS_MIN_BLOCKS),
                "nuts": (resident_nuts.NUTS_LANES, resident_nuts.NUTS_MIN_BLOCKS),
                "hmc": (resident_hmc.HMC_LANES, resident_hmc.HMC_MIN_BLOCKS),
                "walk": (resident_walk.WALK_LANES, resident_walk.WALK_MIN_BLOCKS)}
    runs = [(kernel, *settings[kernel]) for kernel in kernels]
    runs += [run for run in SWEEP if run[0] in kernels and run not in runs]

    def use(kernel, lanes, min_blocks):
        if kernel == "gibbs":
            resident_walk.GIBBS_LANES, resident_walk.GIBBS_MIN_BLOCKS = lanes, min_blocks
        elif kernel == "nuts":
            resident_nuts.NUTS_LANES, resident_nuts.NUTS_MIN_BLOCKS = lanes, min_blocks
        elif kernel == "hmc":
            resident_hmc.HMC_LANES, resident_hmc.HMC_MIN_BLOCKS = lanes, min_blocks
        else:
            resident_walk.WALK_LANES, resident_walk.WALK_MIN_BLOCKS = lanes, min_blocks

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
        else:
            builds.append(resident_walk.library_spec(nuts_model, lanes=lanes))
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
                                   dtype=torch.float32, device=device)}
    hmc_tuned = dict(step=0.1, num_steps=10, tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64)
    ok = True

    def agreement(held, theta, limit, chain_dims, tol=None):
        agree = None
        for got, want, chain_dim in zip(held(args.seed, theta), held.plain(args.seed, theta)[0],
                                        chain_dims):
            chains_ok = chain_agreement(got, want, chain_dim, **(tol or {}))[0]
            agree = chains_ok if agree is None else agree & chains_ok
        share = agree.float().mean().item()
        return {"share_agreeing_with_plain": share, "limit": limit, "ok": share >= limit}

    def report(record, fn, theta, checks):
        nonlocal ok
        ms, ms_runs = event_times(lambda: fn(args.seed, theta))
        ok = ok and all(c["ok"] for c in checks.values())
        print(json.dumps(dict(record, ms=ms, ms_runs=ms_runs, checks=checks)), flush=True)

    for kernel, lanes, min_blocks in runs:
        use(kernel, lanes, min_blocks)
        record = {"kernel": kernel, "lanes": lanes, "min_blocks": min_blocks,
                  "settings": (lanes, min_blocks) == settings[kernel]}
        if kernel == "gibbs":
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
