"""Port, blocked Gibbs on the generic path and its incremental bodies, against
the JAX package. The node-block geometry and ``chunk_evenly`` equal JAX's on
every case of tests/test_gibbs_blocking.py and tests/test_stats.py; one
sweep with given draws equals JAX's ``Gibbs.step`` in float64 (1e-10) on the
draws JAX's key gives; ``sample_chains(Gibbs, backend="scan")`` on XOR
agrees with JAX's scanned Gibbs within 5 pooled standard errors, per-block
acceptance included; the chain statistics read a [C, kept, B] accepted
column as JAX's do; and ``mlp_math.make_incremental_gibbs`` and
``mlp_dense.make_incremental_gibbs_dense`` are within rtol 1e-5 of JAX
(float32; the two libraries round exp and log differently) and bit-equal to
the port's own value-only full forward after any sequence of accepted and
rejected node-block updates."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.chains import ChainList as JChainList
from eeyore_tpu.chains import ChainLists as JChainLists
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.ops import mlp_dense as jdense
from eeyore_tpu.ops import mlp_math as jmath
from eeyore_tpu.samplers import Gibbs as JGibbs
from eeyore_tpu.samplers import sample_chains as jsample_chains
from eeyore_tpu.utils import chunk_evenly as jchunk_evenly
from eeyore_tpu_torch import convert
from eeyore_tpu_torch.chains import ChainList, ChainLists
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops import mlp_dense, mlp_math
from eeyore_tpu_torch.samplers import Gibbs, sample_chain, sample_chains
from eeyore_tpu_torch.utils import chunk_evenly

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])
F64 = dict(rtol=1e-10, atol=1e-10)

# the architectures of tests/test_gibbs_blocking.py
GEOMETRY = [([2, 2, 1], [True, True]), ([2, 3, 3, 2], [True, True, True]),
            ([2, 3, 3, 2], [False, True, True]), ([2, 3, 3, 2], [False, False, False]),
            ([2, 3, 3, 1, 2], [False, True, False, True]), ([4, 3, 3], [True, True]),
            ([4, 3, 2, 3], [True, True, True]), ([784, 10, 10, 10, 10], [True] * 4)]


def models(dims, bias=None, loss="binary_classification", dtype=torch.float64, linear_out=False):
    """(port model, JAX model) of one architecture on the CPU."""
    acts = [mlp.sigmoid] * (len(dims) - 2) + [None] if linear_out else "default"
    jacts = [jmlp.sigmoid] * (len(dims) - 2) + [None] if linear_out else "default"
    port = MLP(loss=loss_functions[loss], dtype=dtype, device="cpu",
               hparams=mlp.Hyperparameters(dims=dims, bias=bias, activations=acts))
    ref = JMLP(loss=jloss_functions[loss],
               dtype=jnp.float64 if dtype == torch.float64 else jnp.float32,
               hparams=jmlp.Hyperparameters(dims=dims, bias=bias, activations=jacts))
    return port, ref


@pytest.mark.parametrize("dims,bias", GEOMETRY, ids=lambda v: str(v))
def test_block_geometry_matches_jax(dims, bias):
    port, ref = models(dims, bias)
    assert port.num_hidden_layers() == ref.num_hidden_layers()
    assert port.num_par_blocks() == ref.num_par_blocks()
    assert port.starting_par_block_indices() == ref.starting_par_block_indices()
    for b in range(port.num_par_blocks()):
        assert port.annotated_par_block_indices(b) == ref.annotated_par_block_indices(b)
        assert port.par_block_indices(b) == ref.par_block_indices(b)
    covered = sorted(i for b in range(port.num_par_blocks()) for i in port.par_block_indices(b))
    assert covered == list(range(port.num_params))
    with pytest.raises(IndexError):
        port.layer_and_node_from_par_block(port.num_par_blocks())


@pytest.mark.parametrize("total,n", [(7, 3), (6, 3), (8, 3), (2, 3), (3, 3), (5, 3), (9, 1),
                                     (5, 2)])
def test_chunk_evenly_matches_jax(total, n):
    assert list(chunk_evenly(range(total), n)) == list(jchunk_evenly(range(total), n))
    with pytest.raises(ValueError, match="positive"):
        list(chunk_evenly(range(total), 0))


def test_blocking_save_and_sub_blocks(tmp_path):
    port, ref = models([2, 2, 1])
    path = tmp_path / "blocks.json"
    Gibbs(port).save_blocks(path)
    assert json.load(open(path)) == [[[0, 1, 4]], [[2, 3, 5]], [[6, 7, 8]]]
    kern = Gibbs(port, scales=[0.1, 0.2, 0.3], node_subblock_size=[1, 1, 2])
    jkern = JGibbs(ref, scales=[0.1, 0.2, 0.3], node_subblock_size=[1, 1, 2])
    assert kern.get_blocks() == jkern.get_blocks()
    assert kern.num_sub_blocks == jkern.num_sub_blocks == 7
    assert [(list(i), s) for i, s, _ in kern.sub_blocks] == [
        (list(i), s) for i, s in jkern._sub_blocks]
    assert [b for _, _, b in kern.sub_blocks] == [0, 0, 0, 1, 1, 1, 2]
    assert Gibbs(port, scales=1).scales == [1.0] * 3


def test_gibbs_needs_parameter_blocks():
    class Flat:
        num_params = 3

    with pytest.raises(ValueError, match="num_par_blocks"):
        Gibbs(Flat())


@pytest.mark.parametrize("subblocks", [None, [1, 2, None]])
def test_step_with_given_draws_equals_jax_step(subblocks):
    """JAX's ``Gibbs.step`` vmapped over chains with one key each, against
    the port's ``step_fn`` fed the normals and uniforms those keys give
    (split into one key per sub-block, each split into the proposal's and
    the accept test's)."""
    port_model, ref_model = models([2, 2, 1])
    C = 64
    rng = np.random.default_rng(0)
    th = 0.5 * rng.normal(size=(C, port_model.num_params))
    x, y = jnp.asarray(XOR_X), jnp.asarray(XOR_Y)
    ref = JGibbs(ref_model, scales=[0.9, 0.6, 1.2], node_subblock_size=subblocks)
    port = Gibbs(port_model, scales=[0.9, 0.6, 1.2], node_subblock_size=subblocks)
    B, W = ref.num_sub_blocks, ref._idx.shape[1]
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    jstate = jax.vmap(ref.init, in_axes=(0, None, None))(jnp.asarray(th), x, y)
    jnew, _ = jax.vmap(ref.step, in_axes=(0, 0, None, None))(keys, jstate, x, y)

    def draws(key):
        subs = jax.random.split(key, B)
        pairs = [jax.random.split(k) for k in subs]
        z = jnp.stack([jax.random.normal(kz, (W,), dtype=jnp.float64) for kz, _ in pairs])
        u = jnp.stack([jax.random.uniform(ka, dtype=jnp.float64) for _, ka in pairs])
        return z, u

    z, u = (np.array(a) for a in jax.vmap(draws)(keys))
    noise = [torch.as_tensor(z[:, b, :len(idx)]) for b, (idx, _, _) in enumerate(port.sub_blocks)]
    tx, ty = torch.as_tensor(XOR_X), torch.as_tensor(XOR_Y)
    state = convert.gibbs_state_from_numpy(jstate, port_model, device="cpu", dtype=torch.float64)
    new, info = port.step_fn(state, tx, ty, noise=noise, uniforms=torch.as_tensor(u))
    np.testing.assert_allclose(new.sample.numpy(), np.asarray(jnew.sample), **F64)
    np.testing.assert_allclose(new.target_val.numpy(), np.asarray(jnew.target_val), **F64)
    np.testing.assert_array_equal(new.accepted.numpy(), np.asarray(jnew.accepted))
    assert new.accepted.shape == (C, B) and 0 < int(new.accepted.sum()) < C * B
    assert info["accepted"] is new.accepted


def test_scan_runs_match_jax_statistically():
    """XOR MLP(2,2,1), ``Gibbs(scales=0.5)``, 256 chains, 600 iterations, 200
    burn-in, from the same theta0s: pooled means of the samples and of the
    per-block acceptance within 5 pooled standard errors."""
    port_model, ref_model = models([2, 2, 1])
    C = 256
    th = 0.1 * np.random.default_rng(6).normal(size=(C, port_model.num_params))
    keys = ("sample", "accepted")
    got = sample_chains(Gibbs(port_model, scales=0.5), torch.Generator().manual_seed(7),
                        torch.as_tensor(th), (XOR_X, XOR_Y), 600, 200, record_keys=keys,
                        return_arrays=True, backend="scan")
    want = jsample_chains(JGibbs(ref_model, scales=0.5), jax.random.PRNGKey(1), jnp.asarray(th),
                          (jnp.asarray(XOR_X), jnp.asarray(XOR_Y)), 600, 200, backend="scan",
                          return_arrays=True, record_keys=keys)
    assert got["sample"].shape == (C, 400, 9) and got["accepted"].shape == (C, 400, 3)
    for k in keys:
        a = got[k].double().mean(1).reshape(C, -1).numpy()   # chain means
        b = np.asarray(want[k], dtype=np.float64).mean(1).reshape(C, -1)
        se = np.sqrt(a.var(0, ddof=1) / C + b.var(0, ddof=1) / C)
        assert np.all(np.abs(a.mean(0) - b.mean(0)) <= 5 * se), k
    rates = got["accepted"].double().mean((0, 1))
    assert bool(((rates > 0.05) & (rates < 1.0)).all())


def test_chain_statistics_read_per_block_flags_as_jax():
    flags = np.random.default_rng(1).integers(0, 2, size=(5, 40, 3)).astype(np.int32)
    samples = np.random.default_rng(2).normal(size=(5, 40, 9))
    port = ChainLists.from_arrays({"sample": torch.as_tensor(samples),
                                   "accepted": torch.as_tensor(flags)})
    ref = JChainLists.from_arrays({"sample": samples, "accepted": flags})
    np.testing.assert_allclose(port.acceptance(), ref.acceptance(), **F64)
    chain = ChainList.from_arrays({"sample": torch.as_tensor(samples[0]),
                                   "accepted": torch.as_tensor(flags[0])})
    jchain = JChainList.from_arrays({"sample": samples[0], "accepted": flags[0]})
    assert chain.acceptance_rate() == pytest.approx(jchain.acceptance_rate(), rel=1e-12)
    np.testing.assert_allclose(chain.block_acceptance_rate().numpy(),
                               np.asarray(jchain.block_acceptance_rate()), **F64)


def test_sample_chain_records_per_block_flags_and_gibbs_state():
    port_model, _ = models([2, 2, 1])
    chain, state = sample_chain(Gibbs(port_model, scales=0.5, node_subblock_size=[1, None, None]),
                                torch.Generator().manual_seed(2),
                                torch.zeros(port_model.num_params), (XOR_X, XOR_Y), 60, 20,
                                return_state=True, backend="scan")
    assert chain.column("accepted").shape == (40, 5)
    assert chain.block_acceptance_rate().shape == (5,)
    assert type(state).__name__ == "GibbsState" and state.accepted.shape == (1, 5)
    torch.testing.assert_close(state.sample[0], chain.get_samples()[-1])


# ---- the incremental bodies ----

INCREMENTAL = {
    "bce_mlp221": ([2, 2, 1], None, "binary_classification", False, "xor"),
    "ce_mlp433": ([4, 3, 3], None, "multiclass_classification", True, 20),
    "ce_mlp4323_mixed_bias": ([4, 3, 2, 3], [True, False, True], "multiclass_classification",
                              True, 30),
    "bce_mlp2321": ([2, 3, 2, 1], None, "binary_classification", False, 12),
}


def incremental_case(name):
    dims, bias, loss, linear_out, rows = INCREMENTAL[name]
    port, ref = models(dims, bias, loss, torch.float32, linear_out)
    if rows == "xor":
        return port, ref, XOR_X, XOR_Y
    rng = np.random.default_rng(len(dims) * 100 + rows)
    x = rng.normal(size=(rows, dims[0]))
    y = (np.eye(dims[-1])[rng.integers(0, dims[-1], rows)] if loss.startswith("multi")
         else (rng.uniform(size=(rows, 1)) > 0.5).astype(np.float64))
    return port, ref, x, y


def block_moves(model, C, sweeps=2, seed=7):
    """Per node block in sweep order, the (unit, flat indices, [P, C]
    perturbation) of a proposal, and whether to accept it (alternating)."""
    rng = np.random.default_rng(seed)
    for _ in range(sweeps):
        for b in range(model.num_par_blocks()):
            z = np.zeros((model.num_params, C), dtype=np.float32)
            z[model.par_block_indices(b)] = rng.normal(
                size=(len(model.par_block_indices(b)), C)).astype(np.float32)
            yield model.layer_and_node_from_par_block(b), z, b % 2 == 0


@pytest.mark.parametrize("name", list(INCREMENTAL))
def test_incremental_gibbs_is_the_full_forward_and_matches_jax(name):
    port, ref, x, y = incremental_case(name)
    C = 16
    arrays = mlp_math.prepare_data(port, x, y)
    jarrays = jmath.prepare_data(ref, x, y)
    data = [torch.as_tensor(a) for a in arrays[:5]]
    jdata = [jnp.asarray(a) for a in jarrays[:5]]
    v_full = mlp_math.make_vg(port, *arrays, with_grad=False)
    keys, init, updates = mlp_math.make_incremental_gibbs(port, arrays[0].shape[0], arrays[6],
                                                          arrays[5])
    jkeys, jinit, jupdates = jmath.make_incremental_gibbs(ref, jarrays[0].shape[0], jarrays[6],
                                                          jarrays[5])
    assert keys == jkeys
    theta = np.random.default_rng(3).normal(size=(port.num_params, C)).astype(np.float32)
    val, cache = init(torch.as_tensor(theta), *data)
    jval, jcache = jinit(jnp.asarray(theta), *jdata)
    assert torch.equal(val, v_full(torch.as_tensor(theta), *data))
    for unit, z, accept in block_moves(port, C):
        prop = theta + z
        val_p, cache_p = updates[unit](torch.as_tensor(prop), *data, cache)
        jval_p, jcache_p = jupdates[unit](jnp.asarray(prop), *jdata, jcache)
        assert torch.equal(val_p, v_full(torch.as_tensor(prop), *data)), unit
        np.testing.assert_allclose(val_p.numpy(), np.asarray(jval_p), rtol=1e-5)
        moved = [new is not old for old, new in zip(cache, cache_p)]
        assert moved == [new is not old for old, new in zip(jcache, jcache_p)]
        assert 0 < sum(moved) <= len(cache)
        if accept:
            theta, cache, jcache = prop, cache_p, jcache_p


@pytest.mark.parametrize("name", list(INCREMENTAL))
def test_incremental_gibbs_dense_is_the_full_forward_and_matches_jax(name):
    port, ref, x, y = incremental_case(name)
    C = 16
    v_full = mlp_dense.make_vg_dense(port, x, y, with_grad=False)
    keys, init, updates = mlp_dense.make_incremental_gibbs_dense(port, x, y)
    jkeys, jinit, jupdates = jdense.make_incremental_gibbs_dense(ref, x, y)
    assert keys == jkeys == mlp_dense.gibbs_cache_keys(port, len(x))

    def tiles(theta):
        return tuple(torch.as_tensor(t) for t in theta)

    theta = np.random.default_rng(4).normal(size=(port.num_params, C)).astype(np.float32)
    val, cache = init(tiles(theta))
    jval, jcache = jinit([jnp.asarray(t) for t in theta])
    assert torch.equal(val, v_full(tiles(theta)))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-5)
    for unit, z, accept in block_moves(port, C, seed=8):
        prop = theta + z
        val_p, cache_p = updates[unit](tiles(prop), cache)
        jval_p, jcache_p = jupdates[unit]([jnp.asarray(t) for t in prop], jcache)
        assert torch.equal(val_p, v_full(tiles(prop))), unit
        np.testing.assert_allclose(val_p.numpy(), np.asarray(jval_p), rtol=1e-5)
        moved = [new is not old for old, new in zip(cache, cache_p)]
        assert moved == [new is not old for old, new in zip(jcache, jcache_p)]
        if accept:
            theta, cache, jcache = prop, cache_p, jcache_p
