"""Port, whole-loop walks: the plain versions of ``resident_walk`` (staged
data) and ``resident_walk_dense`` (data as constants), what CPU tensors run
and what the CUDA kernels are held against on the card by
``chip_smoke.py``. Runs equal an explicit loop of the port's
``MetropolisHastings.step_fn`` and ``MALA.step_fn`` on the same Threefry
draws (``kernel_prng.walk_draws``), with exact extras (float32: 1e-5
relative, 2e-4 absolute on iris values of about 1e2, as the HMC tests); the
dense walk tuner equals ``HMCDATuner`` fed the mean rate of each
sublane-strided group; thinning, the makers with tuners and the scaffolds'
argument checks are tested."""

import numpy as np
import pytest
import torch

from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops import kernel_prng, resident_hmc, resident_walk, resident_walk_dense
from eeyore_tpu_torch.ops.resident_walk import make_resident_mala, make_resident_mh
from eeyore_tpu_torch.ops.resident_walk_dense import (
    make_resident_mala_dense,
    make_resident_mh_dense,
)
from eeyore_tpu_torch.samplers import MALA, MetropolisHastings, default_temperatures
from eeyore_tpu_torch.tuners import HMCDATuner

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])


def problem(name):
    if name.startswith("xor"):
        dims = [2, 2, 1] if name == "xor" else [2, 3, 2, 1]
        model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                    device="cpu", hparams=mlp.Hyperparameters(dims=dims))
        return model, XOR_X, XOR_Y
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    model = MLP(loss=loss_functions["multiclass_classification"], dtype=torch.float32,
                device="cpu",
                hparams=mlp.Hyperparameters(dims=[4, 3, 3], activations=[mlp.sigmoid, None]))
    return model, ds.x, ds.y


def theta0s(C, P, seed=0, scale=0.3):
    return torch.as_tensor(scale * np.random.default_rng(seed).normal(size=(C, P)),
                           dtype=torch.float32)


def explicit_loop(model, x, y, move, value, th, seed, iters, burnin):
    """The port's generic samplers stepped on the walk stream's draws:
    [(sample, target_val, accepted & moved)] per iteration, and the
    post-burn-in accept counts."""
    tx, ty = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    sampler = (MetropolisHastings(model, scale=value) if move == "mh"
               else MALA(model, step=value))
    state = sampler.init(th, tx, ty)
    chains = torch.arange(th.shape[0])
    rows, acc = [], torch.zeros(th.shape[0])
    for t in range(iters):
        z, u = kernel_prng.walk_draws(seed, chains, t, model.num_params)
        if move == "mh":
            prop = state.sample + float(np.float32(value)) * z.T
            new, _ = sampler.step_fn(state, tx, ty, proposal=prop, uniforms=u)
        else:
            new, _ = sampler.step_fn(state, tx, ty, noise=z.T, uniforms=u)
        moved = torch.any(new.sample != state.sample, dim=1)
        if t >= burnin:
            acc += new.accepted
        rows.append((new.sample, new.target_val, moved))
        state = new
    return rows, acc


CASES = [("iris", "mh", 0.1, make_resident_mh, 64, 64, 2e-4),
         ("iris", "mala", 0.003, make_resident_mala, 64, 64, 2e-4),
         ("xor", "mh", 0.5, make_resident_mh_dense, 1024, 1024, 1e-5),
         ("xor2321", "mala", 0.1, make_resident_mala_dense, 1024, 1024, 1e-5)]


@pytest.mark.parametrize("name,move,value,maker,C,chain_block,atol", CASES)
def test_run_equals_explicit_loop(name, move, value, maker, C, chain_block, atol):
    model, x, y = problem(name)
    iters, burnin, seed = 14, 4, 3
    th = theta0s(C, model.num_params)
    fn = maker(model, x, y, value, iters, burnin, chain_block=chain_block, record_extras=True,
               device="cpu")
    samples, final, acc, vals, flags = fn(seed, th)
    rows, n_acc = explicit_loop(model, x, y, move, value, th, seed, iters, burnin)
    for t in range(burnin, iters):
        sample, val, moved = rows[t]
        torch.testing.assert_close(samples[t - burnin], sample, rtol=1e-5, atol=atol)
        torch.testing.assert_close(vals[t - burnin], val, rtol=1e-5, atol=atol)
        assert torch.equal(flags[t - burnin].bool(), moved)
    torch.testing.assert_close(final, rows[-1][0], rtol=1e-5, atol=atol)
    assert torch.equal(acc, n_acc)
    assert 0 < acc.sum() < C * (iters - burnin)
    (_, _, _, _, _), info = fn.plain(seed, th)
    assert info["evaluations"] == C * (1 + iters)


def test_dense_walk_tuner_equals_hmcda_tuner_fed_the_group_mean():
    """Tuned dense MH: each sublane-strided group of 1024 chains takes one
    scale, the dual average (``HMCDATuner``, float32, m = log(10 * scale0))
    of the group-mean min(1, exp(log_rate)), frozen at the averaged value
    at the last burn-in iteration."""
    model, x, y = problem("xor")
    C, cb, iters, burnin, seed = 2048, 1024, 12, 9, 5
    tuner = HMCDATuner(d=0.3)
    th = theta0s(C, model.num_params, seed=1)
    fn = make_resident_mh_dense(model, x, y, 0.2, iters, burnin, chain_block=cb, tuner=tuner,
                                device="cpu")
    (samples, final, acc), info = fn.plain(seed, th)

    tx, ty = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    sampler = MetropolisHastings(model)
    state = sampler.init(th, tx, ty)
    gid = resident_hmc.group_index(C, cb, 8)
    groups = tuner.init(torch.full((2,), 0.2), dtype=torch.float32, device="cpu")
    groups = groups._replace(m=torch.full((2,), float(np.float32(np.log(10 * 0.2)))))
    scale = torch.full((2,), float(np.float32(0.2)))
    for t in range(iters):
        z, u = kernel_prng.walk_draws(seed, torch.arange(C), t, model.num_params)
        prop = state.sample + scale[gid][:, None] * z.T
        log_rate = model.log_target(prop, tx, ty) - state.target_val
        state, _ = sampler.step_fn(state, tx, ty, proposal=prop, uniforms=u)
        if t < burnin:
            rate = torch.clamp(torch.exp(torch.clamp(log_rate, max=0.0)), max=1.0)
            means = resident_hmc.group_means(rate, cb, 8)
            groups, scale, _ = tuner.tune(groups, means, t, t != burnin - 1)
        else:
            torch.testing.assert_close(samples[t - burnin], state.sample, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(info["value"], scale[gid], rtol=3e-5, atol=0)
    assert scale[0] != scale[1]
    torch.testing.assert_close(final, state.sample, rtol=1e-5, atol=1e-5)


def test_dense_walk_tuner_state_and_update():
    """``_tuner_init`` starts every group at (0, 0, value);
    ``_population_dual_average`` is the HMC kernels' update while t <
    burn-in and leaves the state alone after."""
    pr = resident_walk.walk_params("mala", 0.1, 20, 5, 1, False, 1024, tuner=HMCDATuner(d=0.5))
    extra = resident_walk._tuner_init(3, 0.1, "cpu")
    assert [e.tolist() for e in extra] == [[0.0] * 3, [0.0] * 3, [pytest.approx(0.1)] * 3]
    rates = torch.tensor([0.2, 0.5, 0.9])
    new = resident_walk._population_dual_average(pr, extra, rates, 0)
    want = resident_hmc._population_tune(pr, 0, extra[0], extra[1], rates)
    for a, b in zip(new, want):
        assert torch.equal(a, b)
    assert new[2][0] < new[2][1] < new[2][2]  # lower acceptance, smaller step
    assert resident_walk._population_dual_average(pr, new, rates, 5) is new


def test_record_thin_and_extras():
    model, x, y = problem("iris")
    C, seed = 64, 9
    th = theta0s(C, model.num_params, seed=3)
    kw = dict(chain_block=64, record_extras=True, device="cpu")
    full = make_resident_mala(model, x, y, 0.003, 14, 2, **kw)(seed, th)
    thin = make_resident_mala(model, x, y, 0.003, 14, 2, record_thin=3, **kw)(seed, th)
    assert thin[0].shape == (4, C, 27) and full[0].shape == (12, C, 27)
    for a, b in zip(thin, full):
        if a.dim() >= 2 and a.shape[0] == 4:
            assert torch.equal(a, b[::3])
    assert torch.equal(thin[1], full[1]) and torch.equal(thin[2], full[2])
    samples, _, acc, _, flags = full
    assert torch.equal(flags[1:].bool(), torch.any(samples[1:] != samples[:-1], dim=-1))
    assert torch.equal(flags.sum(0).float(), acc)


def test_makers_and_unported_arguments():
    """Mirrors the dense walk cases of tests/test_ops.py:173-188 for MH and
    MALA; the scaffolds take a ladder's temperatures only as a 1-D array
    whose size divides the lanes that hold the ladders (the makers are in
    tests/test_torch_resident_tempering.py, the blocked Gibbs move's in
    tests/test_torch_resident_gibbs.py); TPU schedule settings raise."""
    model, x, y = problem("xor")
    make_resident_mh_dense(model, x, y, scale=0.5, num_iters=64, tuner=HMCDATuner(d=0.234),
                           device="cpu")
    make_resident_mala_dense(model, x, y, step=0.1, num_iters=64, tuner=HMCDATuner(d=0.574),
                             device="cpu")
    with pytest.raises(ValueError, match="1024"):
        make_resident_mh_dense(model, x, y, 0.5, 64, chain_block=512, device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        resident_walk._make_resident(model, x, y, 10, 0, 128, 1, "mh", 0.1,
                                     temperatures=np.ones((2, 4)), between_step=2, device="cpu")
    # 1024 / 8 = 128 lanes of a sublane row do not hold whole ladders of 3 rungs
    with pytest.raises(ValueError, match="multiple of the ladder size 3"):
        resident_walk_dense._make_resident_dense(model, x, y, 10, 0, 1024, 1, "mala", 0.1,
                                                 temperatures=default_temperatures(3),
                                                 between_step=2, device="cpu")
    with pytest.raises(ValueError, match="TPU schedule"):
        make_resident_mh(model, x, y, 0.1, 10, stream=True, device="cpu")
    with pytest.raises(ValueError, match="move"):
        resident_walk.walk_params("nuts", 0.1, 10, 0, 1, False, 128)
    fn = make_resident_mh(model, x, y, 0.1, 10, chain_block=128, device="cpu")
    with pytest.raises(ValueError, match="multiple of chain_block"):
        fn(0, torch.zeros(100, 9))
    with pytest.raises(ValueError, match="CUDA tensors"):
        resident_walk.resident_walk(None, "mh", torch.zeros(9, 128), *[torch.zeros(1)] * 5,
                                    resident_walk.ResidentWalkParams(), 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        resident_walk_dense.resident_walk_dense(None, "mh", torch.zeros(9, 1024),
                                                resident_walk.ResidentWalkParams(), 256, 1)
    assert resident_walk.launch_counts[resident_walk.KERNEL] == 0
    assert resident_walk_dense.launch_counts[resident_walk_dense.KERNEL] == 0


def test_walk_stream_is_the_hmc_stream_without_the_rounding_uniform():
    chains = torch.arange(300, dtype=torch.int64)
    z, u = kernel_prng.walk_draws(11, chains, 7, 27)
    mom, u_hmc, _ = kernel_prng.hmc_draws(11, chains, 7, 27)
    assert torch.equal(z, mom) and torch.equal(u, u_hmc)
    assert z.shape == (27, 300) and bool(((u > 0) & (u <= 1)).all())
