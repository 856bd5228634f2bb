"""Port, the lane kernels' sources on the host: ``csrc/resident_walk.cu`` (the
staged Gibbs move, whose chains each take 8, 16 or 32 lanes of a warp, and
the staged MH, MALA and ladder moves, on 1, 2, 4 or 8),
``csrc/resident_nuts.cu`` (staged NUTS, on 1, 8, 16 or 32),
``csrc/resident_hmc.cu`` (staged HMC, on 1, 2, 4 or 8),
``csrc/resident_nuts_dense.cu`` (one thread a chain),
``csrc/resident_walk_dense.cu`` (the dense MH, MALA and ladder moves on 1, 2
or 4, each lane on the generated body of its own rows) and
``csrc/resident_smc.cu`` (the SMC mutation pass, on 1, 4 or 8), written over
the lanes a chain (``csrc/lane_eval.cuh``), compiled with g++ against
``tests/cuda_host_emulation.h``, which runs every thread of a thread-block
cluster as a coroutine, gives each block of it its own shared memory, and
runs the warp shuffles, ballots and barriers and the cluster barrier as
barriers over their members. Their launch entry points, called through
ctypes on CPU tensors, are held against the plain versions (``fn.plain`` of
the makers) per chain: the lane algebra (the row cache and its updates, the
butterfly sums, the gradient's reduce-scatter, the draws spread over the
lanes, the group mean of a tuned group in a block or a cluster, the ladder's
swap round through the chains' posts, the record tile) computes the plain
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
from eeyore_tpu_torch.ops import (
    resident_hmc,
    resident_nuts,
    resident_nuts_dense,
    resident_smc,
    resident_walk,
    resident_walk_dense,
)
from eeyore_tpu_torch.ops._build import CSRC
from eeyore_tpu_torch.ops.fused_mlp import arch_defines
from eeyore_tpu_torch.ops.mlp_math import prepare_data
from eeyore_tpu_torch.ops.resident_hmc import ResidentHMCParams, unpack_outputs
from eeyore_tpu_torch.ops.resident_tempering_dense import make_resident_tempering_dense
from eeyore_tpu_torch.tuners import HMCDATuner

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")

EMULATION = Path(__file__).resolve().parent / "cuda_host_emulation.h"
XOR = (np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]]), np.array([[0.], [1.], [1.], [0.]]))


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """build(source, defines, generated, zero_bits) -> the ctypes library
    of ``csrc/<source>`` compiled for the host, each block's shared memory
    its own in its cluster (``emu::block_smem``, ``emu::shared_array``);
    with ``zero_bits`` Threefry gives zero bits, the draws of Pallas's TPU
    interpreter."""
    root = tmp_path_factory.mktemp("lane_emulation")
    built = {}

    def compile_source(source, defines, generated=None, zero_bits=False):
        key = hashlib.sha256(repr((source, defines, sorted((generated or {}).items()),
                                   zero_bits)).encode()).hexdigest()[:12]
        if key in built:
            return built[key]
        d = root / key
        d.mkdir()
        arrays = iter(range(1 << 20))
        for f in CSRC.iterdir():
            text = f.read_text().replace("extern __shared__ float smem[];",
                                         "float* smem = emu::block_smem();")
            # a block's static shared arrays, in its cluster rank's memory
            text = re.sub(r"__shared__ float (\w+)\[([^\]]+)\];",
                          lambda m: f"float* {m[1]} = emu::shared_array({next(arrays)}, {m[2]});",
                          text)
            assert "__shared__" not in re.sub(r"//.*", "", text), f.name
            if zero_bits and f.name == "kernel_prng.cuh":  # Threefry gives zero bits
                assert "return make_uint2(x0, x1);" in text
                text = text.replace("return make_uint2(x0, x1);", "return make_uint2(0u, 0u);")
            (d / f.name).write_text(text)
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


def walk_defines(model, lanes, ladder_lanes=None):
    """The defines of a walk build: the architecture and the MH and MALA
    moves' and the ladder move's lanes a chain (the launch bounds are the
    card's only)."""
    ladder_lanes = resident_walk.TEMPERING_LANES if ladder_lanes is None else ladder_lanes
    return tuple(arch_defines(model)[1]) + (
        f"WALK_LANES={lanes}", f"WALK_MIN_BLOCKS={resident_walk.WALK_MIN_BLOCKS}",
        f"TEMPERING_LANES={ladder_lanes}",
        f"TEMPERING_MIN_BLOCKS={resident_walk.TEMPERING_MIN_BLOCKS}")


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


@pytest.mark.parametrize("name,lanes,C,threads,cluster", [
    ("xor", 1, 64, 32, 2), ("xor", 1, 128, 32, 4), ("iris_subset", 1, 64, 32, 2),
    ("iris_subset", 8, 32, 128, 2)])
def test_a_tuned_group_as_a_cluster_equals_the_plain_version(build, name, lanes, C, threads,
                                                             cluster):
    """A tuning group larger than a block is a cluster, on one thread a chain
    (staged XOR takes JAX's 4096 chains as 8 blocks of 512 on the card) as
    on lanes: the group mean adds the blocks' sums through the cluster's
    shared memory, and every block applies the same step."""
    model, (x, y) = problem(name)
    lib = build("resident_hmc.cu", tuple(arch_defines(model)[1])
                + (f"HMC_LANES={lanes}", f"HMC_MIN_BLOCKS={resident_hmc.HMC_MIN_BLOCKS}"))
    lib.resident_hmc_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.POINTER(ResidentHMCParams), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 5)
    chain_block = threads * cluster // lanes
    fn = resident_hmc.make_resident_hmc(model, x, y, num_iters=10, chain_block=chain_block,
                                        device="cpu", **dict(HMC_TUNED, record_extras=True))
    theta0s = torch.as_tensor(0.3 * np.random.default_rng(2).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    want, info = fn.plain(4, theta0s)
    cells = closure(fn)
    pr, theta = cells["setup"](4, theta0s)
    P = model.num_params
    samples, final, accepts = (torch.zeros((pr.kept, P + 2, C)), torch.zeros((P, C)),
                               torch.zeros(C))
    evaluations = torch.zeros((), dtype=torch.int64)
    args = (theta.data_ptr(), *(a.data_ptr() for a in cells["arrays"]), ctypes.byref(pr))
    outs = (samples.data_ptr(), final.data_ptr(), accepts.data_ptr(), evaluations.data_ptr(), None)
    # the group must be the cluster: a block of it alone is refused
    assert lib.resident_hmc_launch(*args, threads, 1, *outs) != 0
    assert lib.resident_hmc_launch(*args, threads, cluster, *outs) == 0
    got = unpack_outputs(samples, final, accepts, P, True)
    assert max_err(got, want) < 2e-4
    assert int(evaluations) == info["evaluations"]


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


# ---- the ladder move on 1, 2, 4 or 8 lanes a chain ----

def tempering_library(build, model, lanes, zero_bits=False):
    lib = build("resident_walk.cu", walk_defines(model, resident_walk.WALK_LANES, lanes),
                {"gibbs_blocks.cuh": resident_walk.gibbs_blocks_source(model)}, zero_bits)
    lib.resident_walk_tempering_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7
        + [ctypes.POINTER(resident_walk.ResidentWalkParams), ctypes.c_int] + [ctypes.c_void_p] * 4)
    assert lib.resident_walk_tempering_lanes() == lanes
    return lib


def launch_tempering(lib, fn, move, seed, theta0s, threads):
    """The kernel's outputs as the maker's ``fn`` returns them."""
    cells = closure(fn)
    pr, theta = cells["setup"](seed, theta0s)
    C, P = theta0s.shape
    rows = P + 2 if pr.record_extras else P
    samples, final, accepts = (torch.zeros((pr.kept, rows, C)), torch.zeros((P, C)),
                               torch.zeros((2, C)))
    err = lib.resident_walk_tempering_launch(
        int(move == "mala"), theta.data_ptr(), *(a.data_ptr() for a in cells["arrays"]),
        cells["rungs"].data_ptr(), ctypes.byref(pr), threads, samples.data_ptr(),
        final.data_ptr(), accepts.data_ptr(), None)
    assert err == 0
    return unpack_outputs(samples, final, accepts.T, P, pr.record_extras)


# (problem, lanes, move, rungs, between_step, extras): iris on every lane
# count (a ladder of 8 rungs spans two warps at 8 lanes, so the round's
# barrier is the block's; of 4 rungs at 2 lanes a part of a warp), with and
# without the start-of-iteration moved flag; XOR on one thread a chain (its
# staged layout) and on 2 lanes (4 rows: 2 a lane)
TEMPERING_CASES = [("iris_subset", 1, "mala", 8, 3, True), ("iris_subset", 2, "mh", 4, 2, True),
                   ("iris_subset", 2, "mala", 8, 3, False), ("iris_subset", 4, "mala", 4, 3, True),
                   ("iris_subset", 8, "mala", 8, 3, True), ("iris_subset", 8, "mh", 2, 1, True),
                   ("xor", 1, "mh", 4, 2, True), ("xor", 2, "mala", 4, 3, True)]


@pytest.mark.parametrize("name,lanes,move,L,between,extras", TEMPERING_CASES)
def test_ladder_on_lanes_equals_the_plain_version(build, name, lanes, move, L, between, extras):
    model, (x, y) = problem(name)
    C = 64 if lanes == 1 else 32
    iters, burnin = 12, 3  # four swap rounds of each parity at between_step 1
    value = {"mala": 0.003 if name != "xor" else 0.3, "mh": 0.05 if name != "xor" else 0.5}[move]
    fn = resident_walk._make_resident(model, x, y, iters, burnin, C, 1, move, value,
                                      temperatures=np.linspace(0.1, 1.0, L) ** 2,
                                      between_step=between, record_extras=extras, device="cpu")
    theta0s = torch.as_tensor(0.3 * np.random.default_rng(5).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    want, _ = fn.plain(6, theta0s)
    lib = tempering_library(build, model, lanes)
    got = launch_tempering(lib, fn, move, 6, theta0s, max(32, C * lanes // 2))  # two blocks
    assert max_err(got, want) < 2e-4
    counts = got[2]
    assert torch.equal(counts, want[2])  # within-rung and swap accepts, exact
    assert int(counts[:, 0].sum()) > 0 and int(counts[:, 1].sum()) > 0
    if extras:
        assert torch.equal(got[4], want[4])  # the moved flags


@pytest.mark.parametrize("lanes", [1, 2, 8])
def test_ladder_swaps_follow_jaxs_lattice(build, lanes):
    """With equal temperatures every eligible swap is taken, and with a
    zero walk scale nothing else moves: each round then exchanges exactly
    the pairs of JAX's masks (``ladder_lane_constants``: the (even, even +
    1) pairs, then the (odd, odd + 1) pairs of each ladder, none across a
    ladder's end), applied to theta as JAX's tests apply them, by rolls."""
    from eeyore_tpu.ops.resident_tempering import ladder_lane_constants

    model, (x, y) = problem("iris_subset")
    C, L = 32, 4
    fn = resident_walk._make_resident(model, x, y, 2, 0, C, 1, "mh", 0.0,
                                      temperatures=np.ones(L), between_step=1, device="cpu")
    theta0s = torch.as_tensor(np.random.default_rng(7).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    samples = launch_tempering(tempering_library(build, model, lanes), fn, "mh", 1, theta0s,
                               max(32, C * lanes // 2))[0]
    _, _, m_even, m_odd = ladder_lane_constants(L, C, np.ones(L))
    theta = theta0s.numpy().T
    for t, mask in enumerate((m_even, m_odd)):
        lower = mask > 0.5
        upper = np.roll(lower, 1, axis=1)
        theta = np.where(lower, np.roll(theta, -1, axis=1),
                         np.where(upper, np.roll(theta, 1, axis=1), theta))
        np.testing.assert_array_equal(samples[t].numpy(), theta.T)


def jax_ladder(x, y, sampler, value, temps, between, iters, burnin, C, seed, theta0s):
    """The JAX package's tempering kernel (``eeyore_tpu/ops/resident_tempering.py``)
    on iris MLP(4,3,3), run in Pallas's TPU interpret mode on the CPU, with
    extras; its outputs as torch tensors."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from eeyore_tpu.models import MLP as JMLP
    from eeyore_tpu.models import loss_functions as jloss_functions
    from eeyore_tpu.models import mlp as jmlp
    from eeyore_tpu.ops.resident_tempering import make_resident_tempering

    model = JMLP(loss=jloss_functions["multiclass_classification"], dtype=jnp.float32,
                 hparams=jmlp.Hyperparameters(dims=[4, 3, 3], activations=[jmlp.sigmoid, None]))
    fn = make_resident_tempering(model, np.asarray(x, np.float32), np.asarray(y, np.float32),
                                 len(temps), value, sampler, temps, between, iters, burnin, C,
                                 record_extras=True)
    with pltpu.force_tpu_interpret_mode():
        out = fn(seed, theta0s.numpy())
    return [torch.as_tensor(np.array(o, dtype=np.float32)) for o in out]


# (lanes, move, step or scale): MALA on every lane count; MH, whose zero
# normals propose no move, for the swaps alone
JAX_LADDER_CASES = [(1, "mala", 0.003), (2, "mala", 0.003), (4, "mala", 0.003),
                    (8, "mala", 0.003), (1, "mh", 0.1), (8, "mh", 0.1)]


@pytest.mark.parametrize("lanes,move,value", JAX_LADDER_CASES)
def test_ladder_equals_jaxs_kernel_on_the_interpreters_draws(build, lanes, move, value):
    """Pallas's TPU interpreter gives zero bits for the core's generator, so
    the JAX tempering kernel run there draws every normal 0 and every
    uniform 1 (its bits-to-draws maps: 23 high bits under 1.0's exponent,
    Box-Muller with the polynomial sincos). The lane kernel built with
    Threefry giving zero bits maps them the same way, so both run the same
    tempered accept tests (MALA's drift on T grad, accept when the log rate
    is above 0) and the same swap rounds on the same draws: the same accept
    counts (within-rung and swap) and moved flags, and the samples and
    values within float32 rounding."""
    model, (x, y) = problem("iris_subset")
    C, temps, iters, burnin, between = 32, np.array([0.25, 0.5, 0.75, 1.0]), 12, 2, 2
    theta0s = torch.as_tensor(np.random.default_rng(8).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    fn = resident_walk._make_resident(model, x, y, iters, burnin, C, 1, move, value,
                                      temperatures=temps, between_step=between,
                                      record_extras=True, device="cpu")
    lib = tempering_library(build, model, lanes, zero_bits=True)
    got = launch_tempering(lib, fn, move, 3, theta0s, max(32, C * lanes // 2))
    want = jax_ladder(x, y, {"mala": "MALA", "mh": "MetropolisHastings"}[move], value, temps,
                      between, iters, burnin, C, 3, theta0s)
    assert torch.equal(got[2], want[2])  # within-rung and swap accepts
    assert torch.equal(got[4].to(torch.float32), want[4])  # the moved flags
    for i in (0, 1, 3):  # samples, final, values
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=2e-4)
    within, swaps = got[2].sum(0).tolist()
    assert 0 < swaps < (iters - burnin) // between * C // 2
    assert (0 < within < (iters - burnin) * C) if move == "mala" else within == 0


def test_ladder_launch_refuses_blocks_that_split_a_ladder(build):
    model, (x, y) = problem("iris_subset")
    lib = tempering_library(build, model, 8)
    pr = resident_walk.walk_params("mh", 0.1, 2, 0, 1, False, 32, n_rows=32)
    resident_walk.set_ladder(pr, np.ones(8), 1, "mh", 0.1)
    pr.num_chains = 32
    args = (0, *[None] * 7, ctypes.byref(pr))
    assert lib.resident_walk_tempering_launch(*args, 32, *[None] * 4) != 0  # half a ladder
    assert lib.resident_walk_tempering_launch(*args, 512, *[None] * 4) != 0  # over 256 threads


# ---- dense NUTS on one thread a chain ----

# (launch bound, maker keywords): untuned with extras; tuned with a metric,
# whose group of 1024 chains at the 512-thread bound is a cluster of two
# blocks; a deeper tree
DENSE_NUTS_CASES = [(0, dict(step=0.1, record_extras=True)),
                    (512, dict(step=0.3, tuner=HMCDATuner(d=0.8), num_burnin_iters=3,
                               inv_mass=np.linspace(0.5, 2.0, 9))),
                    (512, dict(step=0.1, max_depth=4, tuner=HMCDATuner(d=0.8),
                               num_burnin_iters=2, record_extras=True))]


@pytest.mark.parametrize("bound,kw", DENSE_NUTS_CASES)
def test_dense_nuts_equals_the_plain_version(build, monkeypatch, bound, kw):
    """The dense kernel on the generated body and metric, its chains
    sublane-strided over the blocks of a group."""
    model, (x, y) = problem("xor")
    kw = dict(kw)
    depth = kw.pop("max_depth", 3)
    monkeypatch.setattr(resident_nuts_dense, "NUTS_DENSE_BOUND", bound)
    _, source, defines, generated = resident_nuts_dense.library_spec(
        model, x, y, depth, kw.get("inv_mass"))
    lib = build(source, defines, generated)
    lib.resident_nuts_dense_launch.argtypes = (
        [ctypes.c_void_p, ctypes.POINTER(ResidentHMCParams), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 6)
    C = chain_block = 1024
    fn = resident_nuts_dense.make_resident_nuts_dense(model, x, y, max_depth=depth, num_iters=5,
                                                      chain_block=chain_block, device="cpu",
                                                      **kw)
    theta0s = torch.as_tensor(0.5 * np.random.default_rng(1).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    want, info = fn.plain(3, theta0s)
    pr, theta = closure(fn)["setup"](3, theta0s, False)
    P = model.num_params
    rows = P + 2 if pr.record_extras else P
    out = (torch.zeros((pr.kept, rows, C)), torch.zeros((P, C)), torch.zeros(C), torch.zeros(C),
           torch.zeros(C))
    # a tuned group is a block of at most the bound's threads, or a cluster
    # of such blocks; untuned chains in blocks of 256
    group = chain_block if pr.tuned else 256
    threads = min(group, bound or 1024)
    err = lib.resident_nuts_dense_launch(theta.data_ptr(), ctypes.byref(pr), threads,
                                         group // threads, *(t.data_ptr() for t in out), None)
    assert err == 0
    got = resident_nuts.unpack_nuts_outputs(*out[:4], P, pr.record_extras)
    assert max_err(got, want) < 2e-4
    assert (out[4] - info["step"]).abs().max().item() <= 1e-4 * info["step"].abs().max().item()
    if bound:  # a block larger than the bound is refused
        assert lib.resident_nuts_dense_launch(theta.data_ptr(), ctypes.byref(pr), 2 * bound, 1,
                                              *(t.data_ptr() for t in out), None) != 0


# ---- the dense MH, MALA and ladder moves on 1, 2 or 4 lanes a chain ----

XOR2321 = "xor2321"
XOR3 = "xor3"  # three of XOR's rows: on 2 lanes, lane 1 lacks a row in its second slot


def dense_problem(name):
    if name == XOR2321:
        return model_of([2, 3, 2, 1], "binary_classification"), XOR
    if name == XOR3:
        return model_of([2, 2, 1], "binary_classification"), (XOR[0][:3], XOR[1][:3])
    return problem(name)


def dense_walk_library(build, model, x, y, lanes):
    """The dense walk build on ``lanes`` lanes a chain of the MH, MALA and
    ladder moves, compiled for the host."""
    _, source, defines, generated = resident_walk_dense.library_spec(model, x, y, None, lanes)
    lib = build(source, defines, generated)
    lib.resident_walk_dense_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(resident_walk.ResidentWalkParams),
         ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4)
    lib.resident_walk_dense_tempering_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.POINTER(resident_walk.ResidentWalkParams), ctypes.c_int]
        + [ctypes.c_void_p] * 4)
    assert lib.resident_walk_dense_lanes() == lanes
    return lib


def launch_dense_walk(lib, fn, move, seed, theta0s, threads, cluster=1):
    """The dense walk kernel's outputs as the maker's ``fn`` returns them."""
    pr, theta = closure(fn)["setup"](seed, theta0s)
    C, P = theta0s.shape
    rows = P + 2 if pr.record_extras else P
    samples, final, accepts = (torch.zeros((pr.kept, rows, C)), torch.zeros((P, C)),
                               torch.zeros(C))
    err = lib.resident_walk_dense_launch(
        resident_walk.MOVES[move], theta.data_ptr(), ctypes.byref(pr), threads, cluster,
        samples.data_ptr(), final.data_ptr(), accepts.data_ptr(), None)
    assert err == 0
    return unpack_outputs(samples, final, accepts, P, pr.record_extras)


@pytest.mark.parametrize("name,lanes", [("xor", 1), ("xor", 2), ("xor", 4), (XOR2321, 1),
                                        (XOR2321, 2), (XOR2321, 4), (XOR3, 2)])
def test_dense_walk_moves_on_lanes_equal_the_plain_version(build, name, lanes):
    """The dense MH and MALA moves on the generated lane body, each lane on
    its own XOR rows (4 rows: 4, 2 or 1 a lane; 3 rows on 2 lanes: the slot
    lane 1 lacks is masked), the chains sublane-strided over blocks of 256
    threads, held per chain against the plain version on the folded body."""
    model, (x, y) = dense_problem(name)
    C, iters, burnin = 1024, 9, 2
    lib = dense_walk_library(build, model, x, y, lanes)
    theta0s = torch.as_tensor(0.5 * np.random.default_rng(1).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    for move, maker, value in (("mh", resident_walk_dense.make_resident_mh_dense, 0.3),
                               ("mala", resident_walk_dense.make_resident_mala_dense, 0.05)):
        fn = maker(model, x, y, value, iters, burnin, chain_block=C, record_extras=True,
                   device="cpu")
        want, _ = fn.plain(3, theta0s)
        got = launch_dense_walk(lib, fn, move, 3, theta0s, 256)
        assert max_err(got, want) < 2e-4, move
        assert 0 < int(got[2].sum()) < C * (iters - burnin), move


@pytest.mark.parametrize("lanes,threads,cluster", [(1, 1024, 1), (2, 256, 8), (4, 256, 16)])
def test_dense_tuned_group_on_lanes_equals_the_plain_version(build, lanes, threads, cluster):
    """A tuned dense MALA group of JAX's 1024 chains over a 5-iteration
    burn-in: one block of one thread a chain, and on lanes a cluster of
    blocks of 256 threads (the group mean counts each chain once and adds
    the blocks' sums through the cluster's shared memory); a block of the
    group alone is refused."""
    model, (x, y) = dense_problem(XOR2321)
    C = 1024
    lib = dense_walk_library(build, model, x, y, lanes)
    fn = resident_walk_dense.make_resident_mala_dense(
        model, x, y, 0.05, 10, 5, chain_block=C, tuner=HMCDATuner(d=0.574), record_extras=True,
        device="cpu")
    theta0s = torch.as_tensor(0.5 * np.random.default_rng(2).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    want, _ = fn.plain(4, theta0s)
    got = launch_dense_walk(lib, fn, "mala", 4, theta0s, threads, cluster)
    assert max_err(got, want) < 2e-4
    if cluster > 1:
        pr, theta = closure(fn)["setup"](4, theta0s)
        assert lib.resident_walk_dense_launch(1, theta.data_ptr(), ctypes.byref(pr), threads, 1,
                                              *[None] * 4) != 0


def test_dense_lane_launches_refuse_blocks_of_scattered_chains(build):
    """On lanes a block's chains must divide a sublane row (chain_block / 8),
    so that the record tile's chains are consecutive."""
    model, (x, y) = dense_problem("xor")
    lib = dense_walk_library(build, model, x, y, 4)
    pr = resident_walk.walk_params("mh", 0.1, 2, 0, 1, False, 1024, sublanes=8)
    pr.num_chains = 1024
    args = (0, None, ctypes.byref(pr))
    assert lib.resident_walk_dense_launch(*args, 1024, 1, *[None] * 4) != 0  # over 256 threads
    pr.chain_block = pr.num_chains = 256  # a sublane row of 32 chains: blocks of 64 split it
    assert lib.resident_walk_dense_launch(*args, 256, 1, *[None] * 4) != 0


def launch_dense_tempering(lib, fn, move, seed, theta0s, threads):
    cells = closure(fn)
    pr, theta = cells["setup"](seed, theta0s)
    C, P = theta0s.shape
    rows = P + 2 if pr.record_extras else P
    samples, final, accepts = (torch.zeros((pr.kept, rows, C)), torch.zeros((P, C)),
                               torch.zeros((2, C)))
    err = lib.resident_walk_dense_tempering_launch(
        int(move == "mala"), theta.data_ptr(), cells["rungs"].data_ptr(), ctypes.byref(pr),
        threads, samples.data_ptr(), final.data_ptr(), accepts.data_ptr(), None)
    assert err == 0
    return unpack_outputs(samples, final, accepts.T, P, pr.record_extras)


@pytest.mark.parametrize("lanes,threads", [(1, 256), (4, 64)])
@pytest.mark.parametrize("move", ["mh", "mala"])
def test_dense_ladder_on_lanes_equals_the_plain_version(build, move, lanes, threads):
    """Ladders of 8 rungs along the sublane rows of a chain block of 1024
    XOR chains: on 4 lanes a block of 64 threads holds two ladders, whose
    pairs swap through their posts; within-rung and swap counts exact."""
    model, (x, y) = dense_problem("xor")
    C, L = 1024, 8
    fn = make_resident_tempering_dense(model, x, y, L, {"mh": 0.5, "mala": 0.1}[move],
                                       {"mh": "MetropolisHastings", "mala": "MALA"}[move],
                                       temperatures=np.linspace(0.1, 1.0, L) ** 2,
                                       between_step=2, num_iters=12, num_burnin_iters=3,
                                       chain_block=C, record_extras=True, device="cpu")
    theta0s = torch.as_tensor(0.5 * np.random.default_rng(5).normal(size=(C, model.num_params)),
                              dtype=torch.float32)
    want, _ = fn.plain(6, theta0s)
    got = launch_dense_tempering(dense_walk_library(build, model, x, y, lanes), fn, move, 6,
                                 theta0s, threads)
    assert max_err(got, want) < 2e-4
    assert torch.equal(got[2], want[2])  # within-rung and swap accepts, exact
    assert int(got[2][:, 0].sum()) > 0 and int(got[2][:, 1].sum()) > 0
    assert torch.equal(got[4], want[4])  # the moved flags


# ---- the SMC mutation pass on 1, 4 or 8 lanes a particle ----

@pytest.mark.parametrize("lanes", [1, 4, 8])
@pytest.mark.parametrize("mutation,step", [("MALA", 0.003), ("MH", 0.01)])
def test_smc_pass_on_lanes_equals_the_plain_version(build, mutation, step, lanes):
    """Two mutation steps of 64 particles on iris (150 rows, staged), each
    particle on 1, 4 or 8 lanes: final theta, pot (the untempered
    log-likelihood of the accepted state) and counts against the plain
    pass."""
    model, (x, y) = problem("iris")
    N = 64
    lib = build(*resident_smc.library_spec(model, lanes)[1:])
    lib.resident_smc_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.POINTER(resident_smc.ResidentSMCParams), ctypes.c_int]
        + [ctypes.c_void_p] * 4)
    assert lib.resident_smc_lanes() == lanes
    fn = resident_smc.make_resident_smc_mutation(model, x, y, step, 2, chain_block=N,
                                                 mutation=mutation, device="cpu")
    theta0s = torch.as_tensor(0.3 * np.random.default_rng(9).normal(size=(N, model.num_params)),
                              dtype=torch.float32)
    want, _ = fn.plain(11, 0.3, theta0s)
    cells = closure(fn.transposed)
    pr, theta = cells["setup"](11, 0.3, theta0s.T)
    P = model.num_params
    final, pot, accepts = torch.zeros((P, N)), torch.zeros(N), torch.zeros(N)
    threads = resident_smc.smc_threads(lanes, 1024, N) // 2  # two blocks
    err = lib.resident_smc_launch(
        resident_smc.MOVES[mutation], theta.data_ptr(), *(a.data_ptr() for a in cells["arrays"]),
        ctypes.byref(pr), threads, final.data_ptr(), pot.data_ptr(), accepts.data_ptr(), None)
    assert err == 0
    assert max_err((final.T, pot), want[:2]) < 2e-4
    assert torch.equal(accepts, want[2])
    assert 0 < int(accepts.sum()) < 2 * N
    if lanes > 1:  # a launch that does not cover the particles exactly is refused
        pr.num_particles = N - 1
        assert lib.resident_smc_launch(0, *[None] * 6, ctypes.byref(pr), threads,
                                       *[None] * 4) != 0
