"""Port, the lane kernels' sources on the host: ``csrc/resident_walk.cu`` (the
staged Gibbs move, whose chains each take 8, 16 or 32 lanes of a warp, and
the staged MH and MALA moves, on 1, 2, 4 or 8), ``csrc/resident_nuts.cu``
(staged NUTS, on 1, 8, 16 or 32) and ``csrc/resident_hmc.cu`` (staged HMC, on
1, 2, 4 or 8), written over the lanes a chain (``csrc/lane_eval.cuh``),
compiled with g++ against ``tests/cuda_host_emulation.h``, which runs every
thread of a block as a coroutine and the warp shuffles, ballots and barriers
as barriers over their lanes. Their launch entry points, called through
ctypes on CPU tensors, are held against the plain versions (``fn.plain`` of
the makers) per chain: the lane algebra (the row cache and its updates, the
butterfly sums, the gradient's reduce-scatter, the draws spread over the
lanes, the group mean of a tuned group, the record tile) computes the plain
versions' function. The card's own compiler and its timings are
``chip_smoke.py``'s."""

import ctypes
import hashlib
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops import resident_hmc, resident_nuts, resident_walk
from eeyore_tpu_torch.ops._build import CSRC
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_math import prepare_data
from eeyore_tpu_torch.ops.resident_hmc import ResidentHMCParams, unpack_outputs
from eeyore_tpu_torch.tuners import HMCDATuner

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")

EMULATION = Path(__file__).resolve().parent / "cuda_host_emulation.h"
XOR = (np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]]), np.array([[0.], [1.], [1.], [0.]]))


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """build(source, defines, generated) -> the ctypes library of
    ``csrc/<source>`` compiled for the host, its shared memory static."""
    root = tmp_path_factory.mktemp("lane_emulation")
    built = {}

    def compile_source(source, defines, generated=None):
        key = hashlib.sha256(repr((source, defines, sorted((generated or {}).items())))
                             .encode()).hexdigest()[:12]
        if key in built:
            return built[key]
        d = root / key
        d.mkdir()
        for f in CSRC.iterdir():
            text = f.read_text().replace("extern __shared__ float smem[];",
                                         "float* smem = emu_smem;")
            (d / f.name).write_text(re.sub(r"\b__shared__\b", "static", text))
        for name, text in (generated or {}).items():
            (d / name).write_text(text)
        (d / "cuda_runtime.h").write_text(f'#include "{EMULATION}"\n')
        (d / "cooperative_groups.h").write_text(f'#include "{EMULATION}"\n')
        lib_path = d / "lib.so"
        subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-include",
                        str(EMULATION), f"-I{d}", *[f"-D{x}" for x in defines],
                        str(d / source), "-o", str(lib_path)], check=True)
        built[key] = ctypes.CDLL(str(lib_path))
        return built[key]

    return compile_source


def model_of(dims, loss="multiclass_classification", activations="default"):
    return MLP(loss=loss_functions[loss], dtype=torch.float32, device="cpu",
               hparams=mlp.Hyperparameters(dims=dims, activations=activations))


def problem(name):
    if name == "xor":
        return model_of([2, 2, 1], "binary_classification"), XOR
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    if name == "iris4323":
        return model_of([4, 3, 2, 3], activations=[mlp.sigmoid, mlp.sigmoid, None]), (ds.x, ds.y)
    if name == "iris_wide":
        return model_of([4, 16, 3], activations=[mlp.sigmoid, None]), (ds.x, ds.y)
    if name == "iris_subset":  # every fifth row: 30 rows of the three classes
        return model_of([4, 3, 3], activations=[mlp.sigmoid, None]), (ds.x[::5], ds.y[::5])
    return model_of([4, 3, 3], activations=[mlp.sigmoid, None]), (ds.x, ds.y)


def walk_defines(model, lanes):
    """The defines of a walk build: the architecture and the MH and MALA
    moves' lanes a chain (the launch bounds are the card's only)."""
    return tuple(arch_defines(model)[1]) + (f"WALK_LANES={lanes}",
                                            f"WALK_MIN_BLOCKS={resident_walk.WALK_MIN_BLOCKS}")


def closure(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def max_err(got, want):
    return max((a.double() - b.double()).abs().max().item() for a, b in zip(got, want))


# (problem, node_subblock_size, scales, lanes, cached): config 4's model on the
# cache at 32 and 16 lanes, with every unit split, and on the whole forward
# pass where 8 lanes put it over the cache budget; staged XOR (BCE) on the
# cache; a model too wide for the cache
GIBBS_CASES = [("iris4323", None, 0.1, 32, True),
               ("iris4323", [3, 3, 3, 2, 2, 2, 2, 2], 0.1, 32, True),
               ("iris4323", None, 0.1, 16, True),
               ("iris4323", [3, 3, 3, 2, 2, 2, 2, 2], 0.1, 8, False),
               ("xor", None, 0.5, 32, True),
               ("xor", [1, 1, 2], 0.5, 8, True),
               ("iris_wide", None, 0.1, 32, False)]


@pytest.mark.parametrize("name,subblocks,scales,lanes,cached", GIBBS_CASES)
def test_gibbs_move_on_lanes_equals_the_plain_version(build, monkeypatch, name, subblocks,
                                                      scales, lanes, cached):
    monkeypatch.setattr(resident_walk, "GIBBS_LANES", lanes)
    model, (x, y) = problem(name)
    C, iters, burnin = 16, 9, 2  # 7 records: a batch of the record tile and part of one
    n_rows = prepare_data(model, x, y)[0].shape[0]
    lib = build("resident_walk.cu", walk_defines(model, resident_walk.WALK_LANES),
                {"gibbs_blocks.cuh": resident_walk.gibbs_blocks_source(model, subblocks, n_rows)})
    lib.resident_walk_gibbs_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.POINTER(resident_walk.ResidentWalkParams), ctypes.c_int]
        + [ctypes.c_void_p] * 4)
    layout = (ctypes.c_int * 4)()
    lib.resident_walk_gibbs_layout(layout)
    assert (layout[0], bool(layout[1])) == (lanes, cached)
    fn = resident_walk.make_resident_gibbs(model, x, y, scales, subblocks, num_iters=iters,
                                           num_burnin_iters=burnin, chain_block=C,
                                           record_extras=True, device="cpu")
    theta0s = torch.as_tensor(0.3 * np.random.default_rng(1).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    want, _ = fn.plain(3, theta0s)
    cells = closure(fn)
    pr, theta = cells["setup"](3, theta0s)
    P, B = model.num_params, len(cells["sub_blocks"])
    samples, final, accepts = (torch.zeros((iters - burnin, P + 2, C)), torch.zeros((P, C)),
                               torch.zeros((B, C)))
    threads = max(32, 2 * lanes)  # several blocks, each staging the data and a record tile
    err = lib.resident_walk_gibbs_launch(
        theta.data_ptr(), *(a.data_ptr() for a in cells["arrays"]), cells["scale_t"].data_ptr(),
        ctypes.byref(pr), threads, samples.data_ptr(), final.data_ptr(), accepts.data_ptr(),
        None)
    assert err == 0
    got = unpack_outputs(samples, final, accepts.T, P, True)
    assert max_err(got, want) < 2e-4
    assert int(got[-1].sum()) > 0  # some proposals moved


def test_gibbs_launch_refuses_more_rows_than_its_cache(build):
    model, (x, y) = problem("xor")
    lib = build("resident_walk.cu", walk_defines(model, resident_walk.WALK_LANES),
                {"gibbs_blocks.cuh": resident_walk.gibbs_blocks_source(model, None, 8)})
    lib.resident_walk_gibbs_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.POINTER(resident_walk.ResidentWalkParams), ctypes.c_int]
        + [ctypes.c_void_p] * 4)
    pr = resident_walk.walk_params("gibbs", 0.0, 2, 0, 1, False, 32, n_rows=40)
    pr.num_chains = 32
    assert lib.resident_walk_gibbs_launch(*[None] * 7, ctypes.byref(pr), 64, *[None] * 4) != 0
    pr.n_rows = 8
    pr.num_chains = 33  # chains the blocks do not cover exactly
    assert lib.resident_walk_gibbs_launch(*[None] * 7, ctypes.byref(pr), 64, *[None] * 4) != 0


# (problem, lanes, maker keywords): untuned, a metric with extras, tuned in one
# tuning group a block, a deeper tree; one thread a chain (the layout of a
# tuning group larger than a cluster of lane blocks, and of the dense kernel)
NUTS_CASES = [("iris", 32, dict(step=0.02)),
              ("iris", 16, dict(step=0.02, inv_mass=np.linspace(0.5, 2.0, 27),
                                record_extras=True, num_burnin_iters=1)),
              ("iris", 8, dict(step=0.02, tuner=HMCDATuner(d=0.8), num_burnin_iters=3)),
              ("xor", 32, dict(step=0.1, max_depth=4, tuner=HMCDATuner(d=0.8),
                               num_burnin_iters=3)),
              ("xor", 8, dict(step=0.1, record_extras=True)),
              ("xor", 1, dict(step=0.1, tuner=HMCDATuner(d=0.8), num_burnin_iters=3,
                              record_extras=True)),
              ("iris", 1, dict(step=0.02, inv_mass=np.linspace(0.5, 2.0, 27)))]


@pytest.mark.parametrize("name,lanes,kw", NUTS_CASES)
def test_nuts_on_lanes_equals_the_plain_version(build, name, lanes, kw):
    model, (x, y) = problem(name)
    kw = dict(kw)
    depth = kw.pop("max_depth", 3)
    C = max(16, 32 // lanes)  # a block of at least a warp
    lib = build("resident_nuts.cu", tuple(arch_defines(model)[1])
                + (f"NUTS_DEPTH={depth}", f"NUTS_LANES={lanes}",
                   f"NUTS_MIN_BLOCKS={resident_nuts.NUTS_MIN_BLOCKS}"))
    lib.resident_nuts_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.POINTER(ResidentHMCParams), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 6)
    fn = resident_nuts.make_resident_nuts(model, x, y, max_depth=depth, num_iters=5,
                                          chain_block=C, device="cpu", **kw)
    theta0s = torch.as_tensor(0.3 * np.random.default_rng(1).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    want, info = fn.plain(3, theta0s)
    cells = closure(fn)
    pr, theta = cells["setup"](3, theta0s)
    P = model.num_params
    rows = P + 2 if pr.record_extras else P
    out = (torch.zeros((pr.kept, rows, C)), torch.zeros((P, C)), torch.zeros(C), torch.zeros(C),
           torch.zeros(C))
    threads = C * lanes  # the tuning group is one block
    err = lib.resident_nuts_launch(
        theta.data_ptr(), *(a.data_ptr() for a in cells["arrays"]), cells["im"].data_ptr(),
        cells["msc"].data_ptr(), ctypes.byref(pr), threads, 1, *(t.data_ptr() for t in out),
        None)
    assert err == 0
    got = resident_nuts.unpack_nuts_outputs(*out[:4], P, pr.record_extras)
    assert max_err(got, want) < 2e-4
    assert (out[4] - info["step"]).abs().max().item() <= 1e-4 * info["step"].abs().max().item()


# ---- staged HMC, MH and MALA on 1, 2, 4 or 8 lanes a chain ----

# (problem, lanes, maker keywords): untuned with extras (several blocks), and
# tuned over a 5-iteration burn-in (the l-rule, stochastic rounding at the
# hand-off; the tuning group one block); one thread a chain is the layout of
# data of few rows (staged XOR) and of the dense kernel
HMC_TUNED = dict(step=0.05, num_steps=3, tuner=HMCDATuner(l=0.15), num_burnin_iters=5,
                 max_num_steps=8, l_rounding="stochastic")
HMC_CASES = [("iris_subset", 1, dict(step=0.05, num_steps=3, record_extras=True)),
             ("iris_subset", 1, HMC_TUNED),
             ("iris_subset", 2, dict(step=0.05, num_steps=3, record_extras=True)),
             ("iris_subset", 2, HMC_TUNED),
             ("iris_subset", 4, dict(step=0.05, num_steps=3, record_extras=True)),
             ("iris_subset", 4, dict(HMC_TUNED, record_extras=True)),
             ("iris_subset", 8, dict(step=0.05, num_steps=3, record_extras=True)),
             ("iris_subset", 8, HMC_TUNED),
             ("xor", 4, dict(step=0.1, num_steps=4, tuner=HMCDATuner(l=0.5),
                             num_burnin_iters=5, record_extras=True))]


@pytest.mark.parametrize("name,lanes,kw", HMC_CASES)
def test_hmc_on_lanes_equals_the_plain_version(build, name, lanes, kw):
    model, (x, y) = problem(name)
    C = 32
    lib = build("resident_hmc.cu", tuple(arch_defines(model)[1])
                + (f"HMC_LANES={lanes}", f"HMC_MIN_BLOCKS={resident_hmc.HMC_MIN_BLOCKS}"))
    lib.resident_hmc_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.POINTER(ResidentHMCParams), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 5)
    assert lib.resident_hmc_lanes() == lanes
    fn = resident_hmc.make_resident_hmc(model, x, y, num_iters=10, chain_block=C, device="cpu",
                                        **kw)
    theta0s = torch.as_tensor(0.3 * np.random.default_rng(1).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    want, info = fn.plain(3, theta0s)
    cells = closure(fn)
    pr, theta = cells["setup"](3, theta0s)
    P = model.num_params
    rows = P + 2 if pr.record_extras else P
    samples, final, accepts = torch.zeros((pr.kept, rows, C)), torch.zeros((P, C)), torch.zeros(C)
    evaluations = torch.zeros((), dtype=torch.int64)
    # a tuned group is one block; untuned chains in two blocks, each staging
    # the data, its theta slots and its record tile
    threads = C * lanes if pr.tuned else max(32, C * lanes // 2)
    err = lib.resident_hmc_launch(
        theta.data_ptr(), *(a.data_ptr() for a in cells["arrays"]), ctypes.byref(pr), threads, 1,
        samples.data_ptr(), final.data_ptr(), accepts.data_ptr(), evaluations.data_ptr(), None)
    assert err == 0
    got = unpack_outputs(samples, final, accepts, P, pr.record_extras)
    assert max_err(got, want) < 2e-4
    assert int(evaluations) == info["evaluations"]  # once a chain, not once a lane
    assert 0 < int(accepts.sum()) < C * pr.kept  # some accepted, some not


@pytest.mark.parametrize("name,lanes", [("iris_subset", 1), ("iris_subset", 2),
                                        ("iris_subset", 4), ("iris_subset", 8), ("xor", 4)])
def test_walk_moves_on_lanes_equal_the_plain_version(build, name, lanes):
    model, (x, y) = problem(name)
    C, iters, burnin = 32, 9, 2
    lib = build("resident_walk.cu", walk_defines(model, lanes),
                {"gibbs_blocks.cuh": resident_walk.gibbs_blocks_source(model)})
    lib.resident_walk_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.POINTER(resident_walk.ResidentWalkParams), ctypes.c_int] + [ctypes.c_void_p] * 4)
    assert lib.resident_walk_lanes() == lanes
    theta0s = torch.as_tensor(0.3 * np.random.default_rng(1).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    steps = {"mh": 0.5, "mala": 0.5} if name == "xor" else {"mh": 0.05, "mala": 0.003}
    for move, maker in (("mh", resident_walk.make_resident_mh),
                        ("mala", resident_walk.make_resident_mala)):
        value = steps[move]
        fn = maker(model, x, y, value, iters, burnin, chain_block=C, record_extras=True,
                   device="cpu")
        want, _ = fn.plain(3, theta0s)
        cells = closure(fn)
        pr, theta = cells["setup"](3, theta0s)
        P = model.num_params
        samples, final, accepts = (torch.zeros((iters - burnin, P + 2, C)), torch.zeros((P, C)),
                                   torch.zeros(C))
        threads = max(32, C * lanes // 2)  # two blocks on lanes
        err = lib.resident_walk_launch(
            resident_walk.MOVES[move], theta.data_ptr(), *(a.data_ptr() for a in cells["arrays"]),
            ctypes.byref(pr), threads, samples.data_ptr(), final.data_ptr(), accepts.data_ptr(),
            None)
        assert err == 0
        got = unpack_outputs(samples, final, accepts, P, True)
        assert max_err(got, want) < 2e-4, move
        assert 0 < int(accepts.sum()) < C * (iters - burnin), move


def test_lane_launches_refuse_chains_the_blocks_do_not_cover(build):
    """On lanes every thread reaches the record tile's barriers, so a launch
    must cover the chains exactly, and a tuned group must be the block or
    the cluster."""
    model, _ = problem("iris_subset")
    hmc = build("resident_hmc.cu", tuple(arch_defines(model)[1])
                + ("HMC_LANES=4", f"HMC_MIN_BLOCKS={resident_hmc.HMC_MIN_BLOCKS}"))
    hmc.resident_hmc_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.POINTER(ResidentHMCParams), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 5)
    pr = resident_hmc.hmc_params(0.05, 3, 4, 0, 1, None, 8, "round", False, 32, n_rows=32)
    pr.num_chains = 40  # 160 lanes: no block of 64 or 128 covers them
    assert hmc.resident_hmc_launch(*[None] * 6, ctypes.byref(pr), 64, 1, *[None] * 5) != 0
    pr.num_chains = 64
    pr.tuned = 1  # a group of 32 chains is 128 threads: not a block of 64 alone
    assert hmc.resident_hmc_launch(*[None] * 6, ctypes.byref(pr), 64, 1, *[None] * 5) != 0
    assert hmc.resident_hmc_launch(*[None] * 6, ctypes.byref(pr), 2048, 1, *[None] * 5) != 0
    walk = build("resident_walk.cu", walk_defines(model, 4),
                 {"gibbs_blocks.cuh": resident_walk.gibbs_blocks_source(model)})
    walk.resident_walk_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.POINTER(resident_walk.ResidentWalkParams), ctypes.c_int] + [ctypes.c_void_p] * 4)
    wp = resident_walk.walk_params("mh", 0.1, 4, 0, 1, False, 32, n_rows=32)
    wp.num_chains = 40
    assert walk.resident_walk_launch(0, *[None] * 6, ctypes.byref(wp), 64, *[None] * 4) != 0
    wp.num_chains = 32
    assert walk.resident_walk_launch(0, *[None] * 6, ctypes.byref(wp), 512, *[None] * 4) != 0
