"""Port, the lane layout of the staged Gibbs move and the staged NUTS kernel
(``csrc/lane_eval.cuh``): a chain on 8, 16 or 32 lanes of a warp; and of the
staged HMC kernel and the staged MH and MALA moves, on 1, 2, 4 or 8. The host
side is tested here: the launch shape (threads, blocks, cluster, SMs
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
    name, source, defines, generated = resident_walk.library_spec(iris433(), lanes=8)
    assert source == "resident_walk.cu" and name.endswith(
        f"_l8_b{resident_walk.WALK_MIN_BLOCKS}")
    assert "WALK_LANES=8" in defines and "gibbs_blocks.cuh" in generated
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
