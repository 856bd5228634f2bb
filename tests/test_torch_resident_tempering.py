"""Port, whole-loop tempering: the plain versions of the tempering move of
``resident_walk`` (staged data) and ``resident_walk_dense`` (data as
constants), what CPU tensors run and what the CUDA kernels are held against
on the card by ``chip_smoke.py``. Runs equal an explicit loop on the
tempering stream (``kernel_prng.tempering_draws``): the within-rung MH or
MALA step written per chain on the model's own autograd log-target, and the
even/odd swap rounds written pair by pair (float32: 1e-5 relative, 2e-4
absolute on iris values of about 1e2); counts and moved flags are exact.
The ladder constants equal the JAX package's; with equal temperatures every
eligible swap is accepted; a staged and a dense run of one seed agree; the
makers check their arguments as JAX's do."""

import math

import numpy as np
import pytest
import torch

from eeyore_tpu.ops.resident_tempering import ladder_lane_constants as jax_ladder_lane_constants
from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops import kernel_prng, resident_walk, resident_walk_dense
from eeyore_tpu_torch.ops.resident_tempering import (
    ladder_lane_constants,
    make_resident_tempering,
)
from eeyore_tpu_torch.ops.resident_tempering_dense import make_resident_tempering_dense
from eeyore_tpu_torch.samplers import default_temperatures

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])


def problem(name, temperature=None):
    if name == "xor":
        model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                    device="cpu", hparams=mlp.Hyperparameters(dims=[2, 2, 1]),
                    temperature=temperature)
        return model, XOR_X, XOR_Y
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    model = MLP(loss=loss_functions["multiclass_classification"], dtype=torch.float32,
                device="cpu",
                hparams=mlp.Hyperparameters(dims=[4, 3, 3], activations=[mlp.sigmoid, None]),
                temperature=temperature)
    return model, ds.x, ds.y


def theta0s(C, P, seed=0, scale=0.3):
    return torch.as_tensor(scale * np.random.default_rng(seed).normal(size=(C, P)),
                           dtype=torch.float32)


def explicit_loop(model, x, y, move, value, rungs, between_step, th, seed, iters, burnin):
    """The tempering algebra chain by chain: [(sample, untempered value,
    moved)] per iteration and the post-burn-in counts [C, 2]."""
    tx, ty = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    C, P = th.shape
    L = len(rungs)
    temps = torch.as_tensor(np.float32(rungs))[torch.arange(C) % L]
    f32 = np.float32
    theta = th.clone()
    if move == "mala":
        val, grad = model.upto_grad_log_target(theta, tx, ty)
    else:
        val = model.log_target(theta, tx, ty)
    rows, counts = [], torch.zeros(C, 2)
    for t in range(iters):
        z, u, u_swap = kernel_prng.tempering_draws(seed, torch.arange(C), t, P)
        z = z.T
        start = theta.clone()
        if move == "mala":
            half = float(f32(0.5 * value))
            prop = (theta + half * (temps[:, None] * grad)) + float(f32(math.sqrt(value))) * z
            v_p, g_p = model.upto_grad_log_target(prop, tx, ty)
            d = theta - (prop + half * (temps[:, None] * g_p))
            log_rate = (temps * (v_p - val) - float(f32(0.5 / value)) * (d * d).sum(1)
                        + 0.5 * (z * z).sum(1))
        else:
            prop = theta + float(f32(value)) * z
            v_p = model.log_target(prop, tx, ty)
            log_rate = temps * (v_p - val)
        accept = torch.log(u) < log_rate
        theta = torch.where(accept[:, None], prop, theta)
        val = torch.where(accept, v_p, val)
        if move == "mala":
            grad = torch.where(accept[:, None], g_p, grad)
        if t >= burnin:
            counts[:, 0] += accept
        if t % between_step == 0:
            parity = (t // between_step) % 2
            for i in range(C):
                rung = i % L
                if rung % 2 != parity or rung == L - 1:
                    continue
                j = i + 1
                if math.log(u_swap[i]) < float((temps[i] - temps[j]) * (val[j] - val[i])):
                    pair = torch.tensor([j, i])
                    theta[[i, j]] = theta[pair]
                    val[[i, j]] = val[pair]
                    if move == "mala":
                        grad[[i, j]] = grad[pair]
                    if t >= burnin:
                        counts[i, 1] += 1
        rows.append((theta.clone(), val.clone(), torch.any(theta != start, dim=1)))
    return rows, counts


CASES = [("iris", "mala", 0.003, 4, make_resident_tempering, 128, 128, 2e-4),
         ("iris", "mh", 0.1, 8, make_resident_tempering, 128, 128, 2e-4),
         ("xor", "mala", 0.1, 8, make_resident_tempering_dense, 1024, 1024, 1e-5),
         ("xor", "mh", 0.3, 4, make_resident_tempering_dense, 1024, 1024, 1e-5)]


@pytest.mark.parametrize("name,move,value,L,maker,C,chain_block,atol", CASES)
def test_run_equals_explicit_loop(name, move, value, L, maker, C, chain_block, atol):
    model, x, y = problem(name)
    iters, burnin, between, seed = 20, 5, 3, 4
    th = theta0s(C, model.num_params)
    rungs = default_temperatures(L)
    fn = maker(model, x, y, L, value, "MALA" if move == "mala" else "MetropolisHastings",
               between_step=between, num_iters=iters, num_burnin_iters=burnin,
               chain_block=chain_block, record_extras=True, device="cpu")
    samples, final, counts, vals, flags = fn(seed, th)
    rows, want_counts = explicit_loop(model, x, y, move, value, rungs, between, th, seed,
                                      iters, burnin)
    for t in range(burnin, iters):
        sample, val, moved = rows[t]
        torch.testing.assert_close(samples[t - burnin], sample, rtol=1e-5, atol=atol)
        torch.testing.assert_close(vals[t - burnin], val, rtol=1e-5, atol=atol)
        assert torch.equal(flags[t - burnin].bool(), moved)
    torch.testing.assert_close(final, rows[-1][0], rtol=1e-5, atol=atol)
    assert counts.shape == (C, 2) and torch.equal(counts, want_counts)
    assert 0 < counts[:, 0].sum() < C * (iters - burnin)
    assert 0 < counts[:, 1].sum() and bool((counts[torch.arange(C) % L == L - 1, 1] == 0).all())
    (_, _, plain_counts, _, _), info = fn.plain(seed, th)
    assert torch.equal(plain_counts, counts) and info["evaluations"] == C * (1 + iters)
    last = (resident_walk_dense if maker is make_resident_tempering_dense else resident_walk)
    assert torch.equal(last.last_info[last.TEMPERING_KERNEL]["accept_counts"], counts)


def eligible_swaps(C, L, iters, burnin, between):
    """Post-burn-in swap rounds in which each chain is the lower member of a
    pair (validate_resident.py:293-307 reckons them so)."""
    rounds = np.arange(burnin, iters)
    rounds = rounds[rounds % between == 0]
    parities = (rounds // between) % 2
    rung = np.arange(C) % L
    eligible = np.where(rung % 2 == 0, (parities == 0).sum(), (parities == 1).sum())
    return np.where(rung == L - 1, 0, eligible)


@pytest.mark.parametrize("maker,chain_block,L", [(make_resident_tempering, 256, 8),
                                                 (make_resident_tempering_dense, 1024, 4)])
def test_equal_temperatures_accept_every_eligible_swap(maker, chain_block, L):
    """With one temperature on every rung the swap log-rate is exactly 0, so
    every eligible swap is accepted: this pins the swap algebra, the parity
    of the rounds and the lower-member counting."""
    model, x, y = problem("xor")
    iters, burnin, between = 40, 6, 4
    fn = maker(model, x, y, L, 0.1, "MALA", temperatures=np.ones(L), between_step=between,
               num_iters=iters, num_burnin_iters=burnin, chain_block=chain_block, device="cpu")
    counts = fn(3, theta0s(chain_block, model.num_params, seed=2))[2]
    assert np.array_equal(counts[:, 1].numpy(), eligible_swaps(chain_block, L, iters, burnin,
                                                               between))


def test_dense_and_staged_runs_of_one_seed_agree():
    """Both draw from the tempering stream keyed by the global chain and
    lay the ladders out alike (rung = chain % L); the two bodies differ only
    in float32 rounding."""
    model, x, y = problem("xor")
    th = theta0s(2048, model.num_params, seed=5)
    kw = dict(num_rungs=8, step=0.1, sampler="MALA", between_step=5, num_iters=30,
              num_burnin_iters=10, device="cpu")
    staged = make_resident_tempering(model, x, y, chain_block=256, **kw)(11, th)
    dense = make_resident_tempering_dense(model, x, y, chain_block=1024, **kw)(11, th)
    close = torch.isclose(staged[0], dense[0], rtol=1e-4, atol=1e-4).all(dim=2).all(dim=0)
    assert close.float().mean().item() >= 0.99
    assert (staged[2] == dense[2]).all(dim=1).float().mean().item() >= 0.99


@pytest.mark.parametrize("L,cb", [(4, 16), (8, 64), (1, 8), (8, 1024)])
def test_ladder_lane_constants_equal_jax(L, cb):
    temps = default_temperatures(L)
    for got, want in zip(ladder_lane_constants(L, cb, temps),
                         jax_ladder_lane_constants(L, cb, temps)):
        assert got.dtype == np.float32 and np.array_equal(got, want)
    with pytest.raises(ValueError, match="multiple"):
        ladder_lane_constants(3, 16, [0.1, 0.5, 1.0])
    with pytest.raises(ValueError, match="temperatures"):
        ladder_lane_constants(4, 16, [0.1, 0.5, 1.0])


def test_tempering_stream_extends_the_walk_stream():
    """``walk_draws`` is a prefix of ``tempering_draws``, and the swap
    uniform is the word after the accept uniform."""
    chains = torch.arange(300, dtype=torch.int64)
    z, u, u_swap = kernel_prng.tempering_draws(11, chains, 7, 27)
    wz, wu = kernel_prng.walk_draws(11, chains, 7, 27)
    assert torch.equal(z, wz) and torch.equal(u, wu)
    word, _ = kernel_prng.threefry2x32(11, chains, 7, (27 + 1) // 2 + 1)
    assert torch.equal(u_swap, kernel_prng.uniform(word)) and not torch.equal(u_swap, u)


def test_makers_check_their_arguments():
    """Mirrors tests/test_ops.py:190-205 and :264-277: another sampler, a
    tempered model, a block that does not hold whole ladders; the kernels'
    wrappers refuse CPU tensors."""
    model, x, y = problem("xor")
    for maker, cb in ((make_resident_tempering, 128), (make_resident_tempering_dense, 1024)):
        with pytest.raises(ValueError, match="sampler"):
            maker(model, x, y, num_rungs=4, sampler="HMC", chain_block=cb, device="cpu")
        with pytest.raises(ValueError, match="untempered"):
            maker(problem("xor", temperature=0.5)[0], x, y, num_rungs=4, chain_block=cb,
                  device="cpu")
        with pytest.raises(ValueError, match="multiple"):
            maker(model, x, y, num_rungs=3, chain_block=cb, device="cpu")
        with pytest.raises(ValueError, match="between_step"):
            maker(model, x, y, num_rungs=4, between_step=0, chain_block=cb, device="cpu")
    with pytest.raises(ValueError, match="multiple"):  # 1024 / 8 lanes do not hold 256 rungs
        make_resident_tempering_dense(model, x, y, num_rungs=256, chain_block=1024, device="cpu")
    fn = make_resident_tempering(model, x, y, 4, num_iters=4, chain_block=128, device="cpu")
    with pytest.raises(ValueError, match="multiple of chain_block"):
        fn(0, torch.zeros(100, 9))
    with pytest.raises(ValueError, match="CUDA tensors"):
        resident_walk.resident_walk_tempering(None, "mh", torch.zeros(9, 128),
                                              *[torch.zeros(1)] * 6,
                                              resident_walk.ResidentWalkParams(), 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        resident_walk_dense.resident_walk_dense_tempering(
            None, "mala", torch.zeros(9, 1024), torch.zeros(4), resident_walk.ResidentWalkParams(),
            256)
    assert resident_walk.launch_counts[resident_walk.TEMPERING_KERNEL] == 0
    assert resident_walk_dense.launch_counts[resident_walk_dense.TEMPERING_KERNEL] == 0


@pytest.mark.parametrize("max_threads,cb,L,want", [
    (1024, 4096, 8, 256), (256, 128, 8, 128), (1024, 2048, 512, 512), (384, 4096, 128, 256),
    (256, 1024, 64, 256), (1024, 8192, 1, 256)])
def test_ladder_threads_hold_whole_ladders(max_threads, cb, L, want):
    assert resident_walk.ladder_threads(max_threads, cb, L) == want


def test_ladder_threads_raise_when_no_block_holds_a_ladder():
    with pytest.raises(ValueError, match="does not fit"):
        resident_walk.ladder_threads(256, 4096, 512)
