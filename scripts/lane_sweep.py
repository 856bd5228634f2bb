"""One-off probe of the lane kernels' settings on a CUDA card: config 4's
staged Gibbs move (iris MLP(4,3,2,3), ``Gibbs(scales=0.1)``) and the staged
iris NUTS kernel (MLP(4,3,3), depth 3, tuned), each built at the modules'
settings and at the other lanes a chain and occupancy targets of ``SWEEP``,
held against its plain version and timed at its main path's shape.

Run from the root of the repository on a machine with a card:

    python3 scripts/lane_sweep.py [--seed 0]

It prints the card's name and power limit, then one JSON line per build: the
lanes a chain, the blocks an SM must hold (which caps the registers), the
build's registers and local bytes, the launch (blocks, the card's occupancy,
SMs covered), the share of chains that agree with the plain version (Gibbs:
every unit split, 32768 chains x 20 iterations, extras; NUTS: untuned, 16384
chains x 5 iterations) and the kernel's time at the main path's shape
(Gibbs: 32768 chains x 2048 iterations, 1024 burn-in; NUTS: 16384 chains x
2048 iterations, 1024 burn-in, tuning groups of 256), the median of three
launches after a warm-up. The modules' settings (``resident_walk.GIBBS_LANES``
and ``GIBBS_MIN_BLOCKS``, ``resident_nuts.NUTS_LANES`` and
``NUTS_MIN_BLOCKS``) are the fastest of such a run; this script sets them in
its own process only, build by build.
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
    RESIDENT_MIN_AGREEING,
    card_line,
    chain_agreement,
    event_times,
)

# (kernel, lanes a chain, blocks an SM must hold); the modules' own settings
# are measured too
SWEEP = (("gibbs", 32, 1), ("gibbs", 32, 2), ("gibbs", 16, 2), ("gibbs", 8, 2),
         ("nuts", 8, 4), ("nuts", 8, 6), ("nuts", 16, 2), ("nuts", 32, 1))
# node sub-blocks that split every unit of iris MLP(4,3,2,3)
SPLIT_UNITS = [3, 3, 3, 2, 2, 2, 2, 2]
C_GIBBS, C_NUTS, ITERS, BURNIN, NUTS_DEPTH = 32768, 16384, 2048, 1024, 3


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lane_sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from eeyore_tpu_torch.datasets import XYDataset
    from eeyore_tpu_torch.models import MLP, loss_functions, mlp
    from eeyore_tpu_torch.ops import _build, resident_nuts, resident_walk
    from eeyore_tpu_torch.ops.fused_mlp import arch_defines
    from eeyore_tpu_torch.ops.mlp_math import prepare_data
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
                "nuts": (resident_nuts.NUTS_LANES, resident_nuts.NUTS_MIN_BLOCKS)}
    runs = [(kernel, *settings[kernel]) for kernel in ("gibbs", "nuts")] + list(SWEEP)

    def use(kernel, lanes, min_blocks):
        if kernel == "gibbs":
            resident_walk.GIBBS_LANES, resident_walk.GIBBS_MIN_BLOCKS = lanes, min_blocks
        else:
            resident_nuts.NUTS_LANES, resident_nuts.NUTS_MIN_BLOCKS = lanes, min_blocks

    # every build at once, under the names the makers load them by: the
    # settings go into the generated header or the defines before any build
    builds = []
    for kernel, lanes, min_blocks in runs:
        use(kernel, lanes, min_blocks)
        if kernel == "gibbs":
            tag, defines = arch_defines(gibbs_model)
            for subs in (None, SPLIT_UNITS):
                builds.append((f"{resident_walk.KERNEL}_{tag}", "resident_walk.cu", defines, {
                    "gibbs_blocks.cuh": resident_walk.gibbs_blocks_source(gibbs_model, subs,
                                                                          n_rows)}))
        else:
            tag, defines = arch_defines(nuts_model)
            builds.append((f"{resident_nuts.KERNEL}_{tag}_d{NUTS_DEPTH}_l{lanes}_b{min_blocks}",
                           "resident_nuts.cu", tuple(defines) + (
                               f"NUTS_DEPTH={NUTS_DEPTH}", f"NUTS_LANES={lanes}",
                               f"NUTS_MIN_BLOCKS={min_blocks}"), None))
        use(kernel, *settings[kernel])
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        for future in [pool.submit(_build.load_library, *b) for b in builds]:
            future.result()

    print(card_line(), flush=True)
    gibbs_theta0s = torch.as_tensor(0.1 * rng.normal(size=(C_GIBBS, gibbs_model.num_params)),
                                    dtype=torch.float32, device=device)
    nuts_theta0s = torch.as_tensor(0.1 * rng.normal(size=(C_NUTS, nuts_model.num_params)),
                                   dtype=torch.float32, device=device)
    ok = True
    for kernel, lanes, min_blocks in runs:
        use(kernel, lanes, min_blocks)
        if kernel == "gibbs":
            fn = resident_walk.make_resident_gibbs(
                gibbs_model, iris.x, iris.y, 0.1, None, num_iters=ITERS,
                num_burnin_iters=BURNIN, chain_block=4096, device=device)
            held = resident_walk.make_resident_gibbs(
                gibbs_model, iris.x, iris.y, 0.1, SPLIT_UNITS, num_iters=20, chain_block=4096,
                record_extras=True, device=device)
            theta0s, launch, limit = gibbs_theta0s, fn.gibbs_launch(C_GIBBS, sm_count), \
                RESIDENT_MIN_AGREEING
            resources = resident_walk.kernel_resources(
                resident_walk.load_kernel(gibbs_model, None, n_rows), "gibbs")
            pairs = zip(held(args.seed, theta0s), held.plain(args.seed, theta0s)[0],
                        (1, 0, 0, 1, 1))
            tol = {}
        else:
            fn = resident_nuts.make_resident_nuts(
                nuts_model, iris.x, iris.y, 0.02, NUTS_DEPTH, ITERS, BURNIN, chain_block=256,
                tuner=HMCDATuner(d=0.8), device=device)
            held = resident_nuts.make_resident_nuts(
                nuts_model, iris.x, iris.y, 0.02, NUTS_DEPTH, 5, chain_block=256, device=device)
            theta0s, launch, limit = nuts_theta0s, fn.nuts_launch(C_NUTS, sm_count), \
                NUTS_MIN_AGREEING
            resources = resident_nuts.kernel_resources(
                resident_nuts.load_kernel(nuts_model, NUTS_DEPTH, lanes))
            pairs = zip(held(args.seed, theta0s), held.plain(args.seed, theta0s)[0], (1, 0, 0, 0))
            tol = dict(atol=NUTS_ATOL, rtol=NUTS_RTOL)
        agree = None
        for got, want, chain_dim in pairs:
            chains_ok = chain_agreement(got, want, chain_dim, **tol)[0]
            agree = chains_ok if agree is None else agree & chains_ok
        share = agree.float().mean().item()
        ms, ms_runs = event_times(lambda: fn(args.seed, theta0s))
        ok = ok and share >= limit
        print(json.dumps({
            "kernel": kernel, "lanes": lanes, "min_blocks": min_blocks,
            "settings": (lanes, min_blocks) == settings[kernel], "resources": resources,
            "launch": launch, "chains": theta0s.shape[0], "iterations": ITERS, "burnin": BURNIN,
            "ms": ms, "ms_runs": ms_runs, "share_agreeing_with_plain": share, "limit": limit}),
            flush=True)
        use(kernel, *settings[kernel])
        del fn, held
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
