"""Port, the lane layout of the staged Gibbs move and the staged NUTS kernel
(``csrc/lane_eval.cuh``): a chain on 8, 16 or 32 lanes of a warp; and of the
staged HMC kernel and the staged MH and MALA moves, on 1, 2, 4 or 8; and of
the dense MH, MALA and ladder moves (lanes by move, rows, group and chain
block) and the SMC mutation pass (lanes by rows). The host side is tested
here: the launch shape (threads, blocks, cluster, SMs
covered) from register counts and the occupancy the card reports, the rule that decides whether the Gibbs move
caches the rows' activations and the generated header that carries it, the
makers' and wrappers' refusals, and that dispatch routes the Gibbs and NUTS
configurations to the same kernels as before. The kernels themselves run on
the card only (``chip_smoke.py`` holds them against their plain versions)."""

import re

import numpy as np
import pytest
import torch

from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops import resident_hmc, resident_nuts, resident_walk
from eeyore_tpu_torch.ops.mlp_math import prepare_data
from eeyore_tpu_torch.ops.resident_hmc_dense import lane_launch
from eeyore_tpu_torch.samplers import HMC, MALA, NUTS, Gibbs, MetropolisHastings
from eeyore_tpu_torch.samplers.dispatch import resolve_backend
from eeyore_tpu_torch.tuners import HMCDATuner

H100_SMS = 132
REGISTERS_PER_SM = 65536  # Hopper's, allocated to a warp in units of 256
XOR = (np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]]), np.array([[0.], [1.], [1.], [0.]]))


def model_of(dims, loss="multiclass_classification", activations="default"):
    return MLP(loss=loss_functions[loss], dtype=torch.float32, device="cpu",
               hparams=mlp.Hyperparameters(dims=dims, activations=activations))


def iris4323():
    return model_of([4, 3, 2, 3], activations=[mlp.sigmoid, mlp.sigmoid, None])


def iris433():
    return model_of([4, 3, 3], activations=[mlp.sigmoid, None])


def xor221():
    return model_of([2, 2, 1], "binary_classification")


def iris_data():
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    return ds.x, ds.y


def threads_for_registers(registers):
    """The most threads a block can have at ``registers`` a thread, as the
    card reports it: registers go to a warp in units of 256."""
    per_warp = -(-32 * registers // 256) * 256
    return min(1024, REGISTERS_PER_SM // per_warp * 32)


def resources(registers):
    return {"registers": registers, "local_bytes": 0,
            "max_threads_per_block": threads_for_registers(registers)}


def occupancy(registers, asked=None):
    """A stand-in for the card's occupancy calculator (``max_blocks`` of
    ``lane_launch``): blocks of ``threads`` an SM holds by threads, blocks
    and registers; records the threads it was asked for in ``asked``."""
    per_warp = -(-32 * registers // 256) * 256

    def max_blocks(threads):
        if asked is not None:
            asked.append(threads)
        return min(2048 // threads, 32, REGISTERS_PER_SM // (threads // 32 * per_warp))

    return max_blocks


# ---- launch shapes ----

@pytest.mark.parametrize("registers,threads", [(255, 256), (167, 384), (142, 448), (128, 512),
                                               (96, 672), (64, 1024), (40, 1024)])
def test_threads_for_registers_follow_the_warp_allocation(registers, threads):
    """The helper above against what the card reported (the parent's
    builds: 255 registers held 256 threads, 167 held 384)."""
    assert threads_for_registers(registers) == threads


@pytest.mark.parametrize("lanes,registers,want", [
    # config 4: 32768 chains, chain_block 4096, no tuning group
    (32, 96, dict(threads=256, blocks=4096, cluster_blocks=1, blocks_per_sm=2)),
    (16, 128, dict(threads=256, blocks=2048, cluster_blocks=1, blocks_per_sm=2)),
    (8, 168, dict(threads=256, blocks=1024, cluster_blocks=1, blocks_per_sm=1)),
])
def test_gibbs_launch_of_config_4(lanes, registers, want):
    asked = []
    shape = lane_launch(32768, lanes, resources(registers), 4096, occupancy(registers, asked),
                        sm_count=H100_SMS)
    assert {k: shape[k] for k in want} == want
    assert asked == [shape["threads"]]
    assert shape["lanes"] == lanes and shape["sms_covered"] == H100_SMS
    assert shape["blocks"] * shape["threads"] == 32768 * lanes
    assert shape["resident_blocks"] == want["blocks_per_sm"] * H100_SMS
    assert shape["waves"] == -(-shape["blocks"] // shape["resident_blocks"])


def test_gibbs_launch_of_staged_xor():
    shape = lane_launch(32768, 32, resources(72), 4096, occupancy(72), sm_count=H100_SMS)
    assert (shape["threads"], shape["blocks"], shape["cluster_blocks"]) == (256, 4096, 1)
    assert shape["blocks_per_sm"] == 3 and shape["sms_covered"] == H100_SMS


def test_the_card_occupancy_bounds_the_sms_covered():
    """The blocks an SM holds are the card's word, not the registers': a
    card that holds 8 of a small launch's blocks an SM needs only 8 SMs for
    its first wave, and without the card's SM count nothing is derived."""
    shape = lane_launch(2048, 32, resources(72), 256, lambda threads: 8, sm_count=H100_SMS)
    assert (shape["blocks"], shape["blocks_per_sm"], shape["waves"]) == (256, 8, 1)
    assert shape["sms_covered"] == 32
    shape = lane_launch(2048, 32, resources(72), 256, lambda threads: 8)
    assert shape["sms_covered"] is None and shape["resident_blocks"] is None


def test_nuts_launch_of_iris_reaches_every_sm():
    """Iris NUTS, 16384 chains in tuning groups of 256. At the default 8
    lanes (96 registers, launch bounds of 16 x 8 threads a block) a group is
    2048 threads, a cluster of 16 blocks of 128, 5 blocks an SM, 1024
    blocks; at 32 lanes (128 registers) a cluster of 16 blocks of 512. One
    thread a chain at 255 registers made 64 blocks of 256, half the card's
    SMs."""
    asked = []

    def max_clusters(threads, blocks):
        asked.append((threads, blocks))
        # the clusters of 16 blocks that 132 SMs of 5 (or 1) blocks hold
        return 41 if threads == 128 else 8

    bounded = dict(resources(96), max_threads_per_block=16 * resident_nuts.NUTS_LANES)
    shape = lane_launch(16384, resident_nuts.NUTS_LANES, bounded, 256, occupancy(96),
                        max_clusters, grouped=True, sm_count=H100_SMS)
    assert (shape["threads"], shape["cluster_blocks"], shape["blocks"]) == (128, 16, 1024)
    assert shape["blocks_per_sm"] == 5 and shape["sms_covered"] == H100_SMS
    assert (shape["resident_blocks"], shape["waves"]) == (656, 2)
    shape = lane_launch(16384, 32, resources(128), 256, occupancy(128), max_clusters,
                        grouped=True, sm_count=H100_SMS)
    assert (shape["threads"], shape["cluster_blocks"], shape["blocks"]) == (512, 16, 1024)
    assert shape["sms_covered"] == 128 and asked[:2] == [(128, 16), (128, 16)]
    old = lane_launch(16384, 1, resources(255), 256, occupancy(255), max_clusters, grouped=True,
                      sm_count=H100_SMS)
    assert (old["threads"], old["cluster_blocks"], old["blocks"]) == (256, 1, 64)
    assert old["sms_covered"] == 64


@pytest.mark.parametrize("lanes,registers,want", [(16, 160, (256, 16, 1024)),
                                                  (8, 200, (256, 8, 512))])
def test_nuts_launch_at_fewer_lanes(lanes, registers, want):
    shape = lane_launch(16384, lanes, resources(registers), 256, occupancy(registers),
                        lambda t, b: 1, grouped=True, sm_count=H100_SMS)
    assert (shape["threads"], shape["cluster_blocks"], shape["blocks"]) == want


def test_a_group_no_cluster_holds_raises():
    with pytest.raises(ValueError, match="does not fit one cluster"):
        lane_launch(16384, 32, resources(142), 256, occupancy(142), lambda t, b: 1, grouped=True)
    with pytest.raises(ValueError, match="does not fit one cluster"):
        lane_launch(16384, 32, resources(128), 256, occupancy(128), lambda t, b: 0, grouped=True)


def test_untuned_nuts_blocks_share_nothing():
    shape = lane_launch(16384, 32, resources(128), 256, occupancy(128), sm_count=H100_SMS)
    assert (shape["threads"], shape["cluster_blocks"], shape["blocks"]) == (256, 1, 2048)


# ---- the Gibbs move's cache ----

def header_fields(source):
    fields = dict(re.findall(r"static constexpr (?:int|bool) (k\w+) = (\w+);", source))
    return {k: (v == "true" if v in ("true", "false") else int(v)) for k, v in fields.items()}


@pytest.mark.parametrize("name,model,data,lanes,budget,want", [
    ("config 4", iris4323, iris_data, 32, None,
     dict(rows_per_lane=5, row_floats=5, cache_floats=25, cached=True)),
    ("config 4, 16 lanes", iris4323, iris_data, 16, None,
     dict(rows_per_lane=10, row_floats=5, cache_floats=50, cached=True)),
    ("config 4, 8 lanes", iris4323, iris_data, 8, None,
     dict(rows_per_lane=19, row_floats=5, cache_floats=95, cached=False)),
    ("config 4, 8 lanes, budget 96", iris4323, iris_data, 8, 96,
     dict(rows_per_lane=19, row_floats=5, cache_floats=95, cached=True)),
    ("staged XOR", xor221, lambda: XOR, 32, None,
     dict(rows_per_lane=1, row_floats=2, cache_floats=3, cached=True)),
    ("wide iris MLP(4,32,3)", lambda: model_of([4, 32, 3], activations=[mlp.sigmoid, None]),
     iris_data, 32, None, dict(rows_per_lane=5, row_floats=32, cache_floats=160, cached=False)),
])
def test_cache_fit_rule_and_the_header_that_carries_it(monkeypatch, name, model, data, lanes,
                                                       budget, want):
    monkeypatch.setattr(resident_walk, "GIBBS_LANES", lanes)
    if budget is not None:
        monkeypatch.setattr(resident_walk, "GIBBS_CACHE_BUDGET", budget)
    model = model()
    x, y = data()
    n_rows = prepare_data(model, x, y)[0].shape[0]
    plan = resident_walk.gibbs_lane_plan(model, n_rows)
    assert {k: plan[k] for k in want} == want, name
    assert plan["lanes"] == lanes
    fields = header_fields(resident_walk.gibbs_blocks_source(model, None, n_rows))
    assert fields["kLanes"] == lanes and fields["kCached"] == want["cached"]
    assert fields["kRowsPerLane"] == (want["rows_per_lane"] if want["cached"] else 0)


def test_the_defaults_put_config_4_on_the_cache():
    n_rows = prepare_data(iris4323(), *iris_data())[0].shape[0]
    assert n_rows == 152
    plan = resident_walk.gibbs_lane_plan(iris4323(), n_rows)
    assert plan["lanes"] == resident_walk.GIBBS_LANES and plan["cached"]
    assert plan["cache_floats"] <= resident_walk.GIBBS_CACHE_BUDGET
    fields = header_fields(resident_walk.gibbs_blocks_source(iris4323(), None, n_rows))
    assert fields["kCached"] and fields["kB"] == 8


def test_a_build_for_the_other_moves_takes_no_cache():
    """The MH, MALA and tempering makers and the dense kernels build the
    walk library without a row count: no row cache is compiled in. The row
    count enters the header only with the cache, so a model over the budget
    builds one library for every dataset and for the other moves."""
    plan = resident_walk.gibbs_lane_plan(iris4323(), 0)
    assert not plan["cached"]
    assert header_fields(resident_walk.gibbs_blocks_source(iris4323()))["kCached"] is False
    wide = model_of([4, 32, 3], activations=[mlp.sigmoid, None])
    assert (resident_walk.gibbs_blocks_source(wide, None, 152)
            == resident_walk.gibbs_blocks_source(wide, None, 200)
            == resident_walk.gibbs_blocks_source(wide))
    assert (resident_walk.gibbs_blocks_source(iris4323(), None, 152)
            != resident_walk.gibbs_blocks_source(iris4323()))


@pytest.mark.parametrize("lanes", [1, 4, 12, 64])
def test_lane_counts_outside_a_warps_divisors_raise(monkeypatch, lanes):
    monkeypatch.setattr(resident_walk, "GIBBS_LANES", lanes)
    with pytest.raises(ValueError, match="8, 16 or 32 lanes"):
        resident_walk.gibbs_lane_plan(iris4323(), 152)
    with pytest.raises(ValueError, match="8, 16 or 32 lanes"):
        resident_walk.gibbs_blocks_source(iris4323(), None, 152)
    if lanes != 1:  # one thread a chain is the staged NUTS kernel's layout for large groups
        with pytest.raises(ValueError, match="1 or 8 lanes"):
            resident_nuts.load_kernel(iris433(), 3, lanes)


@pytest.mark.parametrize("lanes", [16, 32])
def test_staged_nuts_builds_only_its_own_lane_count(lanes):
    with pytest.raises(ValueError, match="1 or 8 lanes"):
        resident_nuts.load_kernel(iris433(), 3, lanes)


@pytest.mark.parametrize("chain_block,tuned,lanes", [
    (256, True, 8), (128, True, 8), (512, True, 1), (4096, True, 1), (4096, False, 8)])
def test_a_tuning_group_beyond_a_cluster_of_lane_blocks_takes_one_thread_a_chain(
        chain_block, tuned, lanes):
    """JAX's tuning groups of up to 4096 chains on small data: a cluster of
    16 lane blocks holds 256 chains, so a larger group runs one thread a
    chain; untuned chains share nothing and stay on lanes."""
    assert resident_nuts.LANE_GROUP_CAP == 256
    assert resident_nuts.chain_lanes(chain_block, tuned) == lanes


# ---- makers and wrappers ----

def test_makers_refuse_bad_arguments_and_report_no_launch_off_the_card():
    x, y = iris_data()
    fn = resident_walk.make_resident_gibbs(iris4323(), x, y, 0.1, num_iters=4, chain_block=128,
                                           device="cpu")
    assert fn.gibbs_launch(32768) is None
    with pytest.raises(ValueError, match="multiple of chain_block"):
        fn(0, torch.zeros(100, 32))
    with pytest.raises(IndexError):
        resident_walk.make_resident_gibbs(iris4323(), x, y, 0.1, node_subblock_size=[2, 2],
                                          num_iters=4, device="cpu")
    nuts = resident_nuts.make_resident_nuts(iris433(), x, y, 0.02, 3, 4, chain_block=256,
                                            device="cpu")
    assert nuts.nuts_launch(16384) is None and nuts.launch_shape is None
    with pytest.raises(ValueError, match="max_depth"):
        resident_nuts.make_resident_nuts(iris433(), x, y, 0.02, 0, 4, device="cpu")
    with pytest.raises(ValueError, match="trajectory"):
        resident_nuts.make_resident_nuts(iris433(), x, y, 0.02, 3, 4,
                                         tuner=HMCDATuner(l=0.5), device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    before = (resident_walk.launch_counts[resident_walk.GIBBS_KERNEL],
              resident_nuts.launch_counts[resident_nuts.KERNEL])
    with pytest.raises(ValueError, match="CUDA tensors"):
        resident_walk.resident_walk_gibbs(None, torch.zeros(32, 4096), *[torch.zeros(1)] * 6,
                                          resident_walk.ResidentWalkParams(), 256)
    params = resident_nuts.nuts_params(0.02, 4, 0, 1, None, False, 256, 1)
    with pytest.raises(ValueError, match="CUDA"):
        resident_nuts.resident_nuts(None, torch.zeros((27, 256)), *(torch.zeros(8, 1),) * 5,
                                    torch.ones(27), torch.ones(27), params, 256, 1)
    assert (resident_walk.launch_counts[resident_walk.GIBBS_KERNEL],
            resident_nuts.launch_counts[resident_nuts.KERNEL]) == before


# ---- dispatch ----

@pytest.mark.parametrize("name,kernel,data,C,want", [
    ("config 4", lambda: Gibbs(iris4323(), scales=0.1), iris_data, 32768,
     ("resident", "make_resident_gibbs", 4096)),
    ("config 4 split units", lambda: Gibbs(iris4323(), scales=0.1,
                                           node_subblock_size=[3, 3, 3, 2, 2, 2, 2, 2]),
     iris_data, 32768, ("resident", "make_resident_gibbs", 4096)),
    ("XOR Gibbs", lambda: Gibbs(xor221(), scales=0.5), lambda: XOR, 32768,
     ("dense", "make_resident_gibbs_dense", 8192)),
    ("iris NUTS", lambda: NUTS(iris433(), step=0.02, max_depth=3, fixed_budget=True,
                               tuner=HMCDATuner(d=0.8)), iris_data, 16384,
     ("resident", "make_resident_nuts", 256)),
    ("XOR NUTS", lambda: NUTS(xor221(), step=0.1, max_depth=3, fixed_budget=True,
                              tuner=HMCDATuner(d=0.8)), lambda: XOR, 32768,
     ("dense", "make_resident_nuts_dense", 8192)),
])
def test_dispatch_routes_to_the_same_kernels(name, kernel, data, C, want):
    plan, reason = resolve_backend(kernel(), data(), C, 2048, 1024, platform="cuda")
    assert plan is not None, reason
    assert (plan.backend, plan.maker.__name__, plan.chain_block) == want, name


def test_staged_gibbs_and_nuts_stay_reachable_on_small_data():
    """Every configuration that reached the staged kernels still does:
    XOR asked for ``backend="resident"``."""
    plan, _ = resolve_backend(Gibbs(xor221(), scales=0.5), XOR, 32768, 2048, 1024,
                              platform="cuda", backend="resident")
    assert plan.maker.__name__ == "make_resident_gibbs" and plan.chain_block == 4096
    plan, _ = resolve_backend(NUTS(xor221(), step=0.1, max_depth=3, fixed_budget=True), XOR,
                              32768, 2048, 1024, platform="cuda", backend="resident")
    assert plan.maker.__name__ == "make_resident_nuts" and plan.chain_block == 4096


def test_a_tuned_staged_plan_on_small_data_keeps_jaxs_tuning_group(monkeypatch):
    """Tuned staged NUTS on XOR keeps JAX's group of 4096 chains, whose
    build runs one thread a chain; the card is asked only about groups up to
    JAX's cap (256 on iris), so iris builds only the lane kernel."""
    from eeyore_tpu_torch.samplers import dispatch

    asked = []

    def cap(kernel, x, y, dense, inv_mass, blocks):
        asked.append(blocks)
        return blocks[0]

    monkeypatch.setattr(dispatch, "_nuts_group_cap", cap)
    tuned = dict(step=0.1, max_depth=3, fixed_budget=True, tuner=HMCDATuner(d=0.8))
    plan, reason = resolve_backend(NUTS(xor221(), **tuned), XOR, 32768, 2048, 1024,
                                   platform="cuda", backend="resident")
    assert plan is not None, reason
    assert plan.chain_block == 4096 and resident_nuts.chain_lanes(plan.chain_block, True) == 1
    plan, reason = resolve_backend(NUTS(iris433(), **tuned), iris_data(), 16384, 2048, 1024,
                                   platform="cuda")
    assert plan.chain_block == 256 and resident_nuts.chain_lanes(plan.chain_block, True) == 8
    assert asked == [(4096, 2048, 1024, 512, 256, 128), (256, 128)]


# ---- staged HMC, MH and MALA on lanes ----

class FakeLaneLibrary:
    """The calls of a loaded staged HMC or walk build that the launch
    helpers make, answering as a build of ``lanes`` lanes at ``registers``
    registers a thread would on an H100 (the block bound that the build's
    launch bounds put on its threads included)."""

    def __init__(self, lanes, registers, bound):
        self.lanes, self.registers = lanes, registers
        self.max_threads = min(bound, threads_for_registers(registers))
        self.blocks = occupancy(registers)
        self.asked = []

    def _resources(self, out):
        out[0], out[1], out[2] = self.registers, 0, self.max_threads
        return 0

    def resident_hmc_lanes(self):
        return self.lanes

    def resident_hmc_error_string(self, code):
        return b"refused"

    resident_walk_error_string = resident_hmc_error_string

    resident_walk_lanes = resident_hmc_lanes

    def resident_hmc_resources(self, out):
        return self._resources(out)

    def resident_walk_resources(self, move, out):
        return self._resources(out)

    def resident_hmc_max_blocks(self, threads, n_rows, out):
        out._obj.value = self.blocks(threads)
        return 0

    def resident_walk_max_blocks(self, move, threads, n_rows, out):
        out._obj.value = self.blocks(threads)
        return 0

    def resident_hmc_max_clusters(self, threads, blocks, n_rows, out):
        self.asked.append((threads, blocks))
        out._obj.value = 16
        return 0


@pytest.mark.parametrize("lanes,registers,want", [
    # config 3: 32768 chains in tuning groups of 256, 128 groups
    (1, 254, dict(threads=256, cluster_blocks=1, blocks=128, blocks_per_sm=1, sms_covered=128)),
    (2, 128, dict(threads=512, cluster_blocks=1, blocks=128, blocks_per_sm=1, sms_covered=128)),
    (4, 64, dict(threads=1024, cluster_blocks=1, blocks=128, blocks_per_sm=1,
                 sms_covered=128)),
    (8, 64, dict(threads=256, cluster_blocks=8, blocks=1024, blocks_per_sm=4)),
])
def test_a_tuned_group_of_256_chains_is_one_block_up_to_4_lanes_and_a_cluster_at_8(
        lanes, registers, want):
    lib = FakeLaneLibrary(lanes, registers, resident_hmc.block_threads(lanes))
    shape = resident_hmc.hmc_launch(lib, 32768, 256, 152, True, sm_count=H100_SMS)
    assert {k: shape[k] for k in want} == want
    assert shape["lanes"] == lanes
    assert shape["blocks"] * shape["threads"] == 32768 * lanes
    # a block reduction needs no cluster: the card is asked only at 8 lanes
    assert bool(lib.asked) == (lanes == 8)
    assert resident_hmc.launch_threads(lib, 256, 152, True) == (want["threads"],
                                                                want["cluster_blocks"])


@pytest.mark.parametrize("lanes,registers,want", [
    (1, 254, (256, 128)), (4, 64, (256, 512)), (8, 64, (256, 1024))])
def test_untuned_hmc_blocks_share_nothing(lanes, registers, want):
    """Untuned chains share nothing: blocks of at most 256 threads, no
    cluster, covering the chains exactly."""
    lib = FakeLaneLibrary(lanes, registers, resident_hmc.block_threads(lanes))
    shape = resident_hmc.hmc_launch(lib, 32768, 256, 152, False, sm_count=H100_SMS)
    assert (shape["threads"], shape["blocks"], shape["cluster_blocks"]) == (*want, 1)
    assert not lib.asked
    odd = resident_hmc.hmc_launch(lib, 1056, 1056, 152, False)
    assert odd["threads"] <= 256 and odd["blocks"] * odd["threads"] == 1056 * lanes


@pytest.mark.parametrize("lanes,registers,want", [
    (1, 168, dict(threads=256, blocks=128, blocks_per_sm=1, sms_covered=128)),
    (4, 64, dict(threads=256, blocks=512, blocks_per_sm=4, sms_covered=128)),
    (8, 80, dict(threads=256, blocks=1024, blocks_per_sm=3, sms_covered=132)),
])
def test_walk_launch_of_the_iris_main_paths(lanes, registers, want):
    lib = FakeLaneLibrary(lanes, registers, 1024 if lanes == 1 else resident_walk.WALK_BLOCK)
    for move in ("mh", "mala"):
        shape = resident_walk.walk_launch(lib, move, 32768, 4096, 152, sm_count=H100_SMS)
        assert {k: shape[k] for k in want} == want
        assert shape["lanes"] == lanes and shape["cluster_blocks"] == 1
        assert resident_walk.walk_threads(lib, move, 4096) == want["threads"]


def test_the_lane_choice_follows_the_rows_and_the_group(monkeypatch):
    """Iris (152 padded rows) takes the settings' lanes; staged XOR (8) one
    thread a chain, where a lane would get no rows to split; a tuning group
    larger than a cluster of 16 lane blocks holds takes one thread a chain
    (at 4 lanes a cluster holds 16 x 256 chains, at 8 lanes 16 x 32)."""
    assert resident_hmc.LANE_MIN_ROWS == 32
    assert resident_hmc.chain_lanes(152, 256, True) == resident_hmc.HMC_LANES
    assert resident_hmc.chain_lanes(8, 512, True) == 1
    assert resident_hmc.chain_lanes(8, 1024, False) == 1
    assert resident_walk.chain_lanes(152) == resident_walk.WALK_LANES
    assert resident_walk.chain_lanes(8) == 1
    for lanes, cases in ((2, [(32, 256, True, 2)]),
                         (4, [(152, 4096, True, 4), (152, 8192, True, 1)]),
                         (8, [(152, 512, True, 8), (152, 1024, True, 1),
                              (152, 1024, False, 8)])):
        monkeypatch.setattr(resident_hmc, "HMC_LANES", lanes)
        for n_rows, chain_block, tuned, want in cases:
            assert resident_hmc.chain_lanes(n_rows, chain_block, tuned) == want
    monkeypatch.setattr(resident_walk, "WALK_LANES", 8)
    assert resident_walk.chain_lanes(31) == 1 and resident_walk.chain_lanes(32) == 8
    assert [resident_hmc.block_threads(k) for k in (1, 2, 4, 8)] == [1024, 512, 1024, 256]


@pytest.mark.parametrize("lanes", [0, 3, 16, 32])
def test_hmc_and_walk_lane_counts_other_than_1_2_4_8_raise(monkeypatch, lanes):
    monkeypatch.setattr(resident_hmc, "HMC_LANES", lanes)
    monkeypatch.setattr(resident_walk, "WALK_LANES", lanes)
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        resident_hmc.chain_lanes(152, 256, True)
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        resident_walk.chain_lanes(152)
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        resident_hmc.load_kernel(iris433(), lanes)
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        resident_walk.load_kernel(iris433(), lanes=lanes)


def test_the_settings_name_the_builds():
    """A build's name carries its lanes and occupancy target, so builds at
    other settings never share a library; the defines carry them to the
    source."""
    name, source, defines = resident_hmc.library_spec(iris433(), 2)
    assert source == "resident_hmc.cu" and name.endswith(f"_l2_b{resident_hmc.HMC_MIN_BLOCKS}")
    assert "HMC_LANES=2" in defines and f"HMC_MIN_BLOCKS={resident_hmc.HMC_MIN_BLOCKS}" in defines
    name, source, defines, generated = resident_walk.library_spec(iris433(), lanes=8,
                                                                  ladder_lanes=4)
    assert source == "resident_walk.cu" and name.endswith(
        f"_l8_b{resident_walk.WALK_MIN_BLOCKS}_t4_b{resident_walk.TEMPERING_MIN_BLOCKS}")
    assert "WALK_LANES=8" in defines and "gibbs_blocks.cuh" in generated
    assert "TEMPERING_LANES=4" in defines
    assert (f"TEMPERING_MIN_BLOCKS={resident_walk.TEMPERING_MIN_BLOCKS}" in defines)
    assert resident_walk.library_spec(iris433())[0] != resident_walk.library_spec(
        iris433(), ladder_lanes=1)[0]
    assert resident_hmc.library_spec(iris433())[0] != resident_hmc.library_spec(iris433(), 1)[0]


@pytest.mark.parametrize("name,kernel,data,C,want", [
    ("config 3", lambda: HMC(iris433(), tuner=HMCDATuner(l=0.15, e0=0.02), max_num_steps=64),
     iris_data, 32768, ("resident", "make_resident_hmc", 256)),
    ("iris MH", lambda: MetropolisHastings(iris433(), scale=0.1), iris_data, 32768,
     ("resident", "make_resident_mh", 4096)),
    ("iris MALA", lambda: MALA(iris433(), step=0.003), iris_data, 32768,
     ("resident", "make_resident_mala", 4096)),
    ("XOR HMC", lambda: HMC(xor221(), step=0.05, num_steps=10), lambda: XOR, 131072,
     ("dense", "make_resident_hmc_dense", 8192)),
])
def test_dispatch_sends_hmc_mh_and_mala_to_the_same_kernels(name, kernel, data, C, want):
    plan, reason = resolve_backend(kernel(), data(), C, 2048, 1024, platform="cuda")
    assert plan is not None, reason
    assert (plan.backend, plan.maker.__name__, plan.chain_block) == want, name


def test_staged_xor_hmc_runs_one_thread_a_chain():
    """XOR asked for ``backend="resident"`` (131072 chains, groups of up to
    512) keeps the staged kernel on one thread a chain: its 8 padded rows
    give a lane none to split."""
    for tuner in (None, HMCDATuner(l=0.5)):
        plan, reason = resolve_backend(HMC(xor221(), step=0.05, num_steps=10, tuner=tuner), XOR,
                                       131072, 256, 128 if tuner else 0, platform="cuda",
                                       backend="resident")
        assert plan is not None and plan.maker.__name__ == "make_resident_hmc", reason
        n_rows = prepare_data(xor221(), *XOR)[0].shape[0]
        assert resident_hmc.chain_lanes(n_rows, plan.chain_block, tuner is not None) == 1


# ---- staged HMC tuning groups from the card ----

class NoClusterLibrary(FakeLaneLibrary):
    """A card that schedules no cluster of this build."""

    def resident_hmc_max_clusters(self, threads, blocks, n_rows, out):
        self.asked.append((threads, blocks))
        out._obj.value = 0
        return 0


@pytest.mark.parametrize("registers,chain_block,want", [
    (96, 512, (512, 1)), (96, 1024, (512, 2)), (96, 4096, (512, 8)), (254, 4096, (256, 16))])
def test_a_one_thread_tuned_group_larger_than_a_block_is_a_cluster(registers, chain_block,
                                                                    want):
    """Staged XOR runs one thread a chain; its tuning group, beyond the
    block its registers allow, is a cluster (JAX's 4096 chains: 8 blocks of
    512 at 96 registers), and a group no cluster holds raises."""
    lib = FakeLaneLibrary(1, registers, resident_hmc.block_threads(1))
    assert resident_hmc.launch_threads(lib, chain_block, 8, True) == want
    shape = resident_hmc.hmc_launch(lib, 131072, chain_block, 8, True, sm_count=H100_SMS)
    assert (shape["threads"], shape["cluster_blocks"]) == want
    assert shape["blocks"] * shape["threads"] == 131072
    assert bool(lib.asked) == (want[1] > 1)
    if want[1] > 1:
        with pytest.raises(ValueError, match="does not fit one cluster"):
            resident_hmc.launch_threads(NoClusterLibrary(1, registers, 1024), chain_block, 8,
                                        True)


class CudaData:
    """Data that reads as lying on the card, for dispatch's questions to it
    (its host copy through ``utils.host.host_array``)."""

    def __init__(self, t):
        self.t = torch.as_tensor(t, dtype=torch.float32)
        self.shape = self.t.shape
        self.is_cuda = True

    def __array__(self, dtype=None, copy=None):
        return self.t.numpy()


@pytest.mark.parametrize("name,library,C,want", [
    ("xor", lambda lanes: FakeLaneLibrary(lanes, 96, resident_hmc.block_threads(lanes)), 131072,
     4096),
    ("xor", lambda lanes: NoClusterLibrary(lanes, 96, resident_hmc.block_threads(lanes)), 131072,
     512),
    ("iris", lambda lanes: FakeLaneLibrary(lanes, 128, resident_hmc.block_threads(lanes)), 32768,
     256),
    ("iris", lambda lanes: NoClusterLibrary(lanes, 254, resident_hmc.block_threads(lanes)),
     32768, 128),
])
def test_dispatch_asks_the_card_for_the_staged_hmc_group(monkeypatch, name, library, C, want):
    """A tuned staged HMC plan takes the largest block up to JAX's cap (4096
    below 32 rows, else 256) whose group the build of its lanes holds, as
    the card answers: JAX's 4096 on XOR where clusters of 8 blocks of 512
    fit, and the largest single block where none does."""
    from eeyore_tpu_torch.samplers import dispatch

    loaded = []

    def load_kernel(model, lanes=None):
        loaded.append(lanes)
        return library(lanes)

    monkeypatch.setattr(resident_hmc, "load_kernel", load_kernel)
    model, (x, y) = (xor221(), XOR) if name == "xor" else (iris433(), iris_data())
    kernel = HMC(model, tuner=HMCDATuner(l=0.5), max_num_steps=64)
    blocks = tuple(b for b in (4096, 2048, 1024, 512, 256, 128)
                   if b <= dispatch._jax_resident_cap(CudaData(x)))
    cap = dispatch._hmc_group_cap(kernel, CudaData(x), CudaData(y), blocks)
    assert cap == want
    assert set(loaded) == ({1} if name == "xor" else {resident_hmc.HMC_LANES})
    # untuned chains share nothing: JAX's cap alone, the card not asked
    assert dispatch._hmc_group_cap(HMC(model, step=0.05), CudaData(x), CudaData(y),
                                   (4096,)) is None
    monkeypatch.setattr(dispatch, "_hmc_group_cap", lambda *args: cap)
    plan, reason = resolve_backend(kernel, (x, y), C, 256, 128, platform="cuda",
                                   backend="resident")
    assert plan is not None and plan.chain_block == want, reason


def test_a_card_that_holds_no_staged_hmc_group_says_so(monkeypatch):
    from eeyore_tpu_torch.samplers import dispatch

    monkeypatch.setattr(dispatch, "_hmc_group_cap", lambda *args: 0)
    kernel = HMC(xor221(), tuner=HMCDATuner(l=0.5), max_num_steps=64)
    plan, reason = resolve_backend(kernel, XOR, 8192, 256, 128, platform="cuda")
    assert plan is not None and plan.backend == "dense"  # auto: the dense kernel first
    with pytest.raises(ValueError, match="this card holds no tuning group of this build"):
        resolve_backend(kernel, XOR, 8192, 256, 128, platform="cuda", backend="resident")


# ---- dense NUTS tuning groups ----

class FakeDenseNutsLibrary:
    """The calls of a loaded dense NUTS build that its launch helpers make,
    answering as a build at ``registers`` registers under a launch bound of
    ``bound`` threads (0: none) would on an H100."""

    def __init__(self, registers, bound):
        self.registers = registers
        self.max_threads = min(bound or 1024, threads_for_registers(registers))

    def resident_nuts_dense_resources(self, out):
        out[0], out[1], out[2] = self.registers, 0, self.max_threads
        return 0

    def resident_nuts_dense_max_clusters(self, threads, blocks, out):
        out._obj.value = 8  # a cluster of 16 blocks, one an SM
        return 0

    def resident_nuts_dense_error_string(self, code):
        return b"refused"


@pytest.mark.parametrize("registers,bound,want", [
    (172, 0, {8192: None, 4096: (256, 16)}),        # the parent's build: 256 threads a block
    (128, 512, {8192: (512, 16), 4096: (512, 8)}),  # 128 registers: JAX's 8192
])
def test_dense_nuts_groups_follow_the_registers(registers, bound, want):
    """A tuned group is a block or a cluster of at most 16 blocks that the
    build's registers allow: at 128 registers (launch bounds of one block of
    512 an SM) a cluster holds JAX's 8192 chains, where the parent's 172
    registers held 4096."""
    from eeyore_tpu_torch.ops import resident_nuts_dense

    lib = FakeDenseNutsLibrary(registers, bound)
    for chain_block, shape in want.items():
        if shape is None:
            with pytest.raises(ValueError, match="does not fit one cluster"):
                resident_nuts_dense.group_shape(lib, chain_block)
        else:
            assert resident_nuts_dense.group_shape(lib, chain_block) == shape


def test_dense_nuts_bound_names_the_build():
    from eeyore_tpu_torch.ops import resident_nuts_dense

    assert resident_nuts_dense.NUTS_DENSE_BOUND == 512
    name, source, defines, generated = resident_nuts_dense.library_spec(xor221(), *XOR, 3)
    assert source == "resident_nuts_dense.cu" and name.endswith("_d3_t512")
    assert {"NUTS_DEPTH=3", "NUTS_DENSE_BOUND=512"} <= set(defines)
    assert set(generated) == {"dense_body.cuh", "nuts_metric.cuh"}


# ---- the dense MH, MALA and ladder moves, and the SMC pass, on lanes ----

class FakeDenseWalkLibrary:
    """What the launch code reads of a dense walk build on ``lanes`` lanes
    a chain at ``registers`` (blocks of at most ``bound`` threads)."""

    def __init__(self, lanes, registers, bound):
        self.lanes, self.registers = lanes, registers
        self.max_threads = min(bound, threads_for_registers(registers))
        self.blocks = occupancy(registers)

    def resident_walk_dense_lanes(self):
        return self.lanes

    def resident_walk_dense_error_string(self, code):
        return b"refused"

    def resident_walk_dense_resources(self, move, out):
        out[0], out[1], out[2] = self.registers, 0, self.max_threads
        return 0

    def resident_walk_dense_max_blocks(self, move, threads, extras, out):
        out._obj.value = self.blocks(threads)
        return 0

    def resident_walk_dense_max_clusters(self, move, threads, blocks, out):
        out._obj.value = 8
        return 0


def test_the_dense_lane_count_follows_the_rows(monkeypatch):
    """Each dense move's setting (the sweep's fastest: config 1's MH on one
    thread a chain, config 2's MALA on 2 lanes, the XOR ladder on 4, a row a
    lane); fewer rows take the largest power of two not above them, never
    more lanes than rows; a build's default lanes are the MH move's."""
    from eeyore_tpu_torch.ops import resident_walk_dense as wd

    assert wd.WALK_DENSE_LANES == {"mh": 1, "mala": 2, "ladder": 4}
    assert [wd.dense_lanes(n, "ladder") for n in (1, 2, 3, 4, 5, 32)] == [1, 2, 2, 4, 4, 4]
    assert [wd.dense_lanes(n, "mala") for n in (1, 2, 3, 4)] == [1, 2, 2, 2]
    assert wd.dense_lanes(4, "mh") == 1
    monkeypatch.setattr(wd, "WALK_DENSE_LANES", dict.fromkeys(("mh", "mala", "ladder"), 8))
    assert [wd.dense_lanes(n, "mh") for n in (4, 7, 8, 32)] == [4, 4, 8, 8]
    assert wd.library_spec(xor221(), *XOR)[2][-2] == "WALK_DENSE_LANES=4"


@pytest.mark.parametrize("lanes,n_rows", [(0, 4), (3, 4), (12, 32), (64, 32), (8, 4), (2, 1)])
def test_dense_lane_counts_outside_a_warps_divisors_or_above_the_rows_raise(monkeypatch, lanes,
                                                                           n_rows):
    from eeyore_tpu_torch.ops import mlp_dense
    from eeyore_tpu_torch.ops import resident_walk_dense as wd

    with pytest.raises(ValueError, match="lanes"):
        wd.check_dense_lanes(lanes, n_rows)
    monkeypatch.setattr(wd, "WALK_DENSE_LANES", {"mh": lanes, "mala": lanes, "ladder": lanes})
    if lanes not in wd.LANE_COUNTS:
        with pytest.raises(ValueError, match="lanes"):
            wd.dense_lanes(n_rows, "mala")
    if n_rows == 4:
        with pytest.raises(ValueError, match="lanes"):
            wd.library_spec(xor221(), *XOR, lanes=lanes)
        with pytest.raises(ValueError, match="lanes"):
            mlp_dense.dense_lane_source(xor221(), *XOR, lanes)


@pytest.mark.parametrize("lanes,chain_block,tuned,want", [
    (4, 1024, True, 4), (4, 2048, True, 1), (4, 8192, True, 1), (4, 8192, False, 4),
    (2, 2048, True, 2), (2, 4096, True, 1), (2, 8192, False, 2), (1, 8192, True, 1)])
def test_a_tuned_dense_group_beyond_a_cluster_of_lane_blocks_takes_one_thread_a_chain(
        monkeypatch, lanes, chain_block, tuned, want):
    """A tuning group is a block or a cluster of at most 16 blocks of 256
    threads: at 4 lanes JAX's 1024 chains fit (16 blocks), at 2 lanes 2048;
    larger groups take the build of one thread a chain, decided before the
    launch."""
    from eeyore_tpu_torch.ops import resident_walk_dense as wd

    monkeypatch.setattr(wd, "WALK_DENSE_LANES", {"mh": lanes, "mala": lanes, "ladder": 4})
    for move in ("mh", "mala"):
        assert wd.walk_dense_lanes(4, chain_block, tuned, move) == want


@pytest.mark.parametrize("lanes,registers,chain_block,want", [
    (4, 128, 1024, (256, 16)), (2, 128, 1024, (256, 8)), (1, 64, 8192, (1024, 8)),
    (1, 153, 4096, (256, 16))])
def test_a_tuned_dense_group_keeps_jaxs_chain_block(lanes, registers, chain_block, want):
    """The group's chain_block chains are exactly the block or the cluster
    (threads x blocks = chains x lanes), whatever the lanes."""
    from eeyore_tpu_torch.ops import resident_walk_dense as wd

    lib = FakeDenseWalkLibrary(lanes, registers, 1024 if lanes == 1 else wd.WALK_DENSE_BLOCK)
    assert wd.walk_shape(lib, "mala", chain_block, True) == want
    assert want[0] * want[1] == chain_block * lanes


@pytest.mark.parametrize("lanes,registers,want", [
    (4, 128, dict(threads=256, blocks=512, blocks_per_sm=2, sms_covered=132)),
    (2, 128, dict(threads=256, blocks=256, blocks_per_sm=2, sms_covered=128)),
    (1, 153, dict(threads=256, blocks=128, blocks_per_sm=1, sms_covered=128)),
])
def test_untuned_dense_walks_spread_over_the_sms(lanes, registers, want):
    """Configs 1 and 2 (32768 chains in chain blocks of 8192): on 4 lanes
    512 blocks of 256 threads, 4096 warps, where one thread a chain had 128
    blocks; a block's chains divide a sublane row."""
    from eeyore_tpu_torch.ops import resident_walk_dense as wd

    lib = FakeDenseWalkLibrary(lanes, registers, 1024 if lanes == 1 else wd.WALK_DENSE_BLOCK)
    for move in ("mh", "mala"):
        shape = wd.walk_launch(lib, move, 32768, 8192, False, sm_count=H100_SMS)
        assert {k: shape[k] for k in want} == want
        assert shape["lanes"] == lanes and shape["cluster_blocks"] == 1
        assert shape["blocks"] * shape["threads"] == 32768 * lanes
        assert (8192 // 8) % (shape["threads"] // lanes) == 0
        assert wd.walk_shape(lib, move, 8192, False) == (want["threads"], 1)


def test_the_xor_ladder_entry_point_covers_128_sms():
    """The XOR ladder's entry point runs one chain block of 1024 chains, 128
    ladders of 8 rungs: on 4 lanes 128 blocks of one ladder (32 threads),
    where one thread a chain took 32 blocks of 32 threads; more chains fill
    the card in blocks of 256; a ladder too long for a block of 256 lane
    threads, or a chain block that one thread a chain spreads over the card,
    takes one thread a chain."""
    from eeyore_tpu_torch.ops import resident_walk_dense as wd
    from eeyore_tpu_torch.ops.resident_hmc_dense import SUBLANES

    assert wd.dense_tempering_lanes(4, 8, 1024) == 4
    lib = FakeDenseWalkLibrary(4, 128, wd.WALK_DENSE_BLOCK)
    ladder = dict(lanes=4, sm_count=H100_SMS, threads=lambda C: resident_walk.ladder_threads(
        wd.WALK_DENSE_BLOCK, 1024, 8, 4, C, H100_SMS, SUBLANES))
    launch = wd.tempering_launch(lib, "mala", 1024, False, ladder)
    assert (launch["lanes"], launch["threads"], launch["blocks"]) == (4, 32, 128)
    assert wd.tempering_launch(lib, "mala", 32768, False, ladder)["threads"] == 256
    assert resident_walk.ladder_threads(1024, 1024, 8, 1, 1024, H100_SMS, SUBLANES) == 32
    assert wd.dense_tempering_lanes(4, 64, 1024) == 4
    assert wd.dense_tempering_lanes(4, 128, 2048) == 1
    # a chain block that one thread a chain spreads over the card: 8192
    # chains are 256 warps for 132 SMs (the ladder at size), 1024 are 32
    assert wd.dense_tempering_lanes(4, 8, 1024, H100_SMS) == 4
    assert wd.dense_tempering_lanes(4, 8, 8192, H100_SMS) == 1
    assert wd.dense_tempering_lanes(4, 8, 8192) == 4
    for L, chain_block in ((8, 1024), (64, 1024)):
        for t in resident_walk._ladder_sizes(wd.WALK_DENSE_BLOCK, chain_block, L, 4, SUBLANES):
            assert t % (4 * L) == 0 and (chain_block // SUBLANES) % (t // 4) == 0


def test_smc_lanes_follow_the_rows(monkeypatch):
    """Iris (152 padded rows) takes SMC_LANES lanes a particle, XOR (8) one
    thread; lane counts other than 1, 2, 4 or 8 raise."""
    from eeyore_tpu_torch.ops import resident_smc

    assert resident_smc.smc_lanes(152) == resident_smc.SMC_LANES > 1
    assert resident_smc.smc_lanes(8) == 1 and resident_smc.smc_lanes(31) == 1
    monkeypatch.setattr(resident_smc, "SMC_LANES", 4)
    assert resident_smc.smc_lanes(32) == 4
    for lanes in (0, 3, 16):
        monkeypatch.setattr(resident_smc, "SMC_LANES", lanes)
        with pytest.raises(ValueError, match="1, 2, 4 or 8"):
            resident_smc.smc_lanes(152)
        with pytest.raises(ValueError, match="1, 2, 4 or 8"):
            resident_smc.library_spec(iris433())


@pytest.mark.parametrize("lanes,N,want", [(8, 16384, (256, 512)), (4, 16384, (256, 256)),
                                          (1, 16384, (128, 128)), (8, 1024, (256, 32)),
                                          (1, 1000, (128, 8))])
def test_smc_blocks_cover_the_particles(lanes, N, want):
    """On lanes a launch covers the particles exactly in blocks of a multiple
    of 32 threads (16384 particles on 8 lanes: 512 blocks of 256); one
    thread a particle keeps blocks of SMC_BLOCK and a ragged last one."""
    from eeyore_tpu_torch.ops import resident_smc

    threads = resident_smc.smc_threads(lanes, 1024, N)
    assert (threads, -(-N * lanes // threads)) == want
    assert threads % 32 == 0 and (lanes == 1 or (N * lanes) % threads == 0)


def test_dense_walk_and_smc_settings_name_the_builds():
    from eeyore_tpu_torch.ops import resident_smc
    from eeyore_tpu_torch.ops import resident_walk_dense as wd

    name, source, defines, generated = wd.library_spec(xor221(), *XOR)
    assert source == "resident_walk_dense.cu"
    assert name.endswith(f"_l{wd.WALK_DENSE_LANES['mh']}_b{wd.WALK_DENSE_MIN_BLOCKS}")
    assert f"WALK_DENSE_MIN_BLOCKS={wd.WALK_DENSE_MIN_BLOCKS}" in defines
    assert "dense_lanes.cuh" not in generated  # one thread a chain: the one-thread body
    name, source, defines, generated = wd.library_spec(xor221(), *XOR, lanes=4)
    assert name.endswith(f"_l4_b{wd.WALK_DENSE_MIN_BLOCKS}") and "WALK_DENSE_LANES=4" in defines
    assert set(generated) == {"dense_body.cuh", "dense_gibbs.cuh", "gibbs_blocks.cuh",
                              "dense_lanes.cuh"}
    assert wd.library_spec(xor221(), *XOR, lanes=2)[0] != name
    name, source, defines = resident_smc.library_spec(iris433())
    assert source == "resident_smc.cu"
    assert name.endswith(f"_l{resident_smc.SMC_LANES}_b{resident_smc.SMC_MIN_BLOCKS}")
    assert f"SMC_LANES={resident_smc.SMC_LANES}" in defines
    assert resident_smc.library_spec(iris433(), 1)[0] != name



# ---- the fused log-posterior and the SMC closure pass ----

def test_fused_lanes_follow_the_rows(monkeypatch):
    """Iris (152 padded rows) takes FUSED_LANES lanes a chain; XOR (8 rows)
    and the 10-row deep case (16) one thread; lane counts other than 1, 2, 4
    or 8 raise, and the settings name the build."""
    from eeyore_tpu_torch.ops import fused_mlp

    assert fused_mlp.fused_lanes(152) == fused_mlp.FUSED_LANES
    assert [fused_mlp.fused_lanes(n) for n in (8, 16, 31)] == [1, 1, 1]
    name, source, defines = fused_mlp.library_spec(iris433())
    assert source == "fused_mlp_vg.cu"
    assert name.endswith(f"_l{fused_mlp.FUSED_LANES}_b{fused_mlp.FUSED_MIN_BLOCKS}")
    assert f"FUSED_LANES={fused_mlp.FUSED_LANES}" in defines
    assert f"FUSED_MIN_BLOCKS={fused_mlp.FUSED_MIN_BLOCKS}" in defines
    monkeypatch.setattr(fused_mlp, "FUSED_LANES", 8)
    assert fused_mlp.fused_lanes(32) == 8
    assert fused_mlp.library_spec(iris433())[0] != name
    for lanes in (0, 3, 16):
        monkeypatch.setattr(fused_mlp, "FUSED_LANES", lanes)
        with pytest.raises(ValueError, match="1, 2, 4 or 8"):
            fused_mlp.fused_lanes(152)
        with pytest.raises(ValueError, match="1, 2, 4 or 8"):
            fused_mlp.library_spec(iris433())


@pytest.mark.parametrize("lanes,C,want", [
    (1, 32768, (128, 256)), (2, 32768, (256, 256)), (4, 32768, (256, 512)),
    (8, 32768, (256, 1024)), (2, 131072, (256, 1024)), (1, 131072, (128, 1024)),
    (1, 37, (32, 2)), (8, 37, (32, 10))])
def test_fused_blocks_balance_the_sms(lanes, C, want):
    """The largest block (128 threads on one thread a chain, 256 on lanes)
    where its blocks give every SM two or more; else the block whose busiest
    SM gets the fewest threads, then the one covering more SMs, then the
    larger: iris's 32768 chains on one thread take blocks of 128 (2 on 124
    SMs, 1 on 8; blocks of 96 would put 3 on some), on 2 lanes blocks of 256
    (2 on 124 SMs); every chain is covered, the last block ragged."""
    from eeyore_tpu_torch.ops import fused_mlp

    block = 128 if lanes == 1 else 256  # the build's most threads a block
    threads = fused_mlp.fused_threads(lanes, C, H100_SMS, block)
    assert (threads, -(-C * lanes // threads)) == want
    assert threads % 32 == 0
    assert threads <= block


def test_fused_blocks_fit_the_build_and_the_sm():
    """Blocks the build's registers do not allow, or that the card's
    occupancy calculator puts no block of on an SM, are never taken."""
    from eeyore_tpu_torch.ops import fused_mlp

    assert fused_mlp.fused_threads(2, 131072, H100_SMS, 100) == 96
    asked = []
    assert fused_mlp.fused_threads(2, 131072, H100_SMS, 256,
                                   lambda t: asked.append(t) or int(t <= 64)) == 64
    assert asked == list(range(256, 31, -32))
    with pytest.raises(ValueError, match="fits an SM"):
        fused_mlp.fused_threads(1, 32768, H100_SMS, 1024, lambda t: 0)


class FakeFusedLibrary:
    """What the launch report reads of a fused build of ``lanes`` lanes a
    chain whose source allows ``block`` threads a block."""

    def __init__(self, lanes, block):
        self.lanes, self.block = lanes, block

    def fused_mlp_vg_lanes(self):
        return self.lanes

    def fused_mlp_vg_arch(self, out):
        out[0], out[1], out[2], out[3], out[4] = 35, 4, 3, 1, self.block
        return 0

    def fused_mlp_vg_error_string(self, code):
        return b"refused"

    def fused_mlp_vg_resources(self, out):
        out[0], out[1], out[2] = 64, 0, 1024
        return 0

    def fused_mlp_vg_max_blocks(self, threads, n_rows, out):
        out._obj.value = 2048 // threads
        return 0


@pytest.mark.parametrize("lanes,block,C,want", [
    (1, 128, 32768, (128, 256, 1)), (4, 256, 32768, (256, 512, 1)),
    (4, 256, 131072, (256, 2048, 2))])
def test_fused_launch_takes_the_builds_block_limit(lanes, block, C, want):
    """The launch report caps a block at the most threads the build's
    source allows (its arch entry), not at what its registers allow."""
    from eeyore_tpu_torch.ops import fused_mlp

    launch = fused_mlp.fused_launch(FakeFusedLibrary(lanes, block), C, 152, H100_SMS)
    assert (launch["threads"], launch["blocks"], launch["waves"]) == want
    assert launch["lanes"] == lanes


class FakeClosureLibrary:
    """What the launch report reads of a closure build."""

    def resident_smc_closure_error_string(self, code):
        return b"refused"

    def resident_smc_closure_resources(self, move, out):
        out[0], out[1], out[2] = 48, 0, 1024
        return 0

    def resident_smc_closure_max_blocks(self, move, threads, out):
        out._obj.value = 10
        return 0


def test_the_mixtures_closure_launch():
    """The mixture's 16384 particles on the closure kernel: one thread a
    particle in blocks of SMC_BLOCK, 128 blocks, whose first wave the
    report puts on 13 SMs at the card's 10 blocks an SM (the hardware
    spreads them over 128)."""
    from eeyore_tpu_torch.ops import resident_smc

    launch = resident_smc.closure_launch(FakeClosureLibrary(), "MALA", 16384, H100_SMS)
    assert launch == {"lanes": 1, "threads": 128, "blocks": 128, "blocks_per_sm": 10,
                      "waves": 1, "sms_covered": 13}

# ---- dense XOR HMC: one thread a chain ----

class FakeDenseHMCLibrary:
    """What the launch code reads of a dense HMC build at ``registers``."""

    def __init__(self, registers):
        self.registers = registers
        self.max_threads = threads_for_registers(registers)

    def resident_hmc_dense_error_string(self, code):
        return b"refused"

    def resident_hmc_dense_resources(self, out):
        out[0], out[1], out[2] = self.registers, 0, self.max_threads
        return 0

    def resident_hmc_dense_max_clusters(self, threads, blocks, out):
        out._obj.value = 8
        return 0


@pytest.mark.parametrize("registers,want", [
    (64, dict(threads=256, blocks=512, blocks_per_sm=4, waves=1, sms_covered=128)),
    (80, dict(threads=256, blocks=512, blocks_per_sm=3, waves=2, sms_covered=132)),
    (88, dict(threads=256, blocks=512, blocks_per_sm=2, waves=2, sms_covered=132))])
def test_bench_problem_on_dense_hmc_waves(registers, want):
    """bench.py's problem, 131072 chains in dispatch's chain blocks of 8192,
    untuned, one thread a chain in blocks of 256: at the kernel's 88
    registers, or 80, the run takes two waves; only at 64 (4 blocks an SM)
    one, on 128 SMs."""
    from eeyore_tpu_torch.ops import resident_hmc_dense as hd

    shape = hd.lane_launch(131072, 1, resources(registers), 8192, occupancy(registers),
                           sm_count=H100_SMS)
    assert {k: shape[k] for k in want} == want
    assert shape["cluster_blocks"] == 1 and shape["blocks"] * shape["threads"] == 131072


@pytest.mark.parametrize("registers,chain_block,want", [
    (88, 8192, (512, 16)), (64, 8192, (1024, 8)), (88, 4096, (512, 8)), (64, 4096, (1024, 4)),
    (88, 1024, (512, 2)), (64, 1024, (1024, 1))])
def test_a_population_group_of_dense_hmc_is_a_block_or_a_cluster(registers, chain_block, want):
    """A tuning group's chain_block threads are exactly the block or the
    cluster: JAX's 8192 as 16 blocks of 512 at 88 registers, 8 of 1024 at
    64; a group of 1024 one block of 1024 only at 64."""
    from eeyore_tpu_torch.ops import resident_hmc_dense as hd

    assert hd.group_shape(FakeDenseHMCLibrary(registers), chain_block) == want
    assert want[0] * want[1] == chain_block
