"""Port, whole-loop HMC on dense data: the plain version of
``resident_hmc_dense`` (what CPU tensors run, and what the CUDA kernel is
held against on the card by ``chip_smoke.py``). An untuned run equals the
untuned ``resident_hmc`` plain run of the same seed (the same Threefry
stream, keyed by the global chain; the two bodies differ in float32
rounding only: 2e-5 relative, 1e-4 absolute); population groups are the
TPU layout's sublane-strided sets; ``per_chain`` equals ``HMCDATuner`` fed
each chain's own rate in an explicit loop (float32, 1e-4); the raw tile
outputs, ``dense_input`` and ``samples_buf`` follow the JAX contract; the
launch shape logic, the evaluation counter and the ``ValueError`` cases of
tests/test_ops.py:130-171 are mirrored."""

import numpy as np
import pytest
import torch

from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops import kernel_prng, resident_hmc, resident_hmc_dense
from eeyore_tpu_torch.ops.mlp_dense import stack_chains, unstack_chains
from eeyore_tpu_torch.ops.resident_hmc import make_resident_hmc
from eeyore_tpu_torch.ops.resident_hmc_dense import launch_shape, make_resident_hmc_dense
from eeyore_tpu_torch.samplers import HMC
from eeyore_tpu_torch.tuners import HMCDATuner

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])


def problem(name):
    if name == "xor":
        model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                    device="cpu", hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
        return model, XOR_X, XOR_Y
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    model = MLP(loss=loss_functions["multiclass_classification"], dtype=torch.float32,
                device="cpu",
                hparams=mlp.Hyperparameters(dims=[4, 3, 3], activations=[mlp.sigmoid, None]))
    return model, ds.x[::5], ds.y[::5]


def theta0s(C, P, seed=0, scale=0.1):
    return torch.as_tensor(scale * np.random.default_rng(seed).normal(size=(C, P)),
                           dtype=torch.float32)


@pytest.mark.parametrize("name,step,num_steps", [("xor", 0.3, 6), ("iris30", 0.02, 5)])
def test_untuned_run_equals_resident_hmc(name, step, num_steps):
    model, x, y = problem(name)
    th = theta0s(1024, model.num_params)
    kw = dict(num_iters=12, num_burnin_iters=4, chain_block=1024, record_extras=True,
              device="cpu")
    dense = make_resident_hmc_dense(model, x, y, step, num_steps, **kw)(5, th)
    staged = make_resident_hmc(model, x, y, step, num_steps, **kw)(5, th)
    for a, b in zip(dense, staged):
        assert a.shape == b.shape
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-4)
    assert 0 < dense[2].sum() < 1024 * 8


def test_population_groups_are_sublane_strided():
    """Chain c = s*(C/8) + i*lb + j is in group i (lb = chain_block / 8):
    the step is one value on each such set and differs between sets."""
    model, x, y = problem("xor")
    C, cb = 4096, 1024
    gid = resident_hmc.group_index(C, cb, 8)
    lanes = np.arange(C) % (C // 8)
    np.testing.assert_array_equal(gid.numpy(), lanes // (cb // 8))
    fn = make_resident_hmc_dense(model, x, y, 0.1, 10, 40, 30, chain_block=cb,
                                 tuner=HMCDATuner(l=0.5), device="cpu")
    (samples, _, acc), info = fn.plain(3, theta0s(C, model.num_params, seed=1))
    step = info["step"].reshape(8, 4, 128)  # [sublane, group, lane]
    assert torch.equal(step, step[:1, :, :1].expand(8, 4, 128))
    assert len(set(step[0, :, 0].tolist())) == 4
    torch.testing.assert_close(info["num_steps"],
                               torch.clamp(torch.round(0.5 / info["step"]), 1, 64).int())
    assert abs(acc.mean().item() / 10 - 0.65) < 0.2


def test_per_chain_equals_hmcda_tuner_fed_each_chains_rate():
    """Explicit loop: the port's ``HMC.leapfrog`` (on the dense body) with
    per-chain steps and trajectory lengths on the kernel's Threefry draws,
    and ``HMCDATuner`` (float32) fed each chain's own Metropolis rate, with
    the l-rule per chain and the averaged step frozen at the last burn-in
    iteration. Five burn-in iterations: each chain's tuner turns rounding
    differences of its rate into step differences 1/g = 20 times larger, so
    longer runs part on single chains."""
    model, x, y = problem("xor")
    C, iters, burnin, seed = 1024, 8, 5, 4
    tuner = HMCDATuner(l=1.0, d=0.7)
    th = theta0s(C, model.num_params, seed=2, scale=0.5)
    fn = make_resident_hmc_dense(model, x, y, 0.02, 4, iters, burnin, chain_block=1024,
                                 tuner=tuner, tuner_mode="per_chain", device="cpu")
    (samples, final, acc), info = fn.plain(seed, th)

    hmc = HMC(model)
    dense_vg = resident_hmc_dense.dense_plain_vg(model, x, y)

    def vg(thetas, _x, _y):
        val, grad = dense_vg(thetas.T)
        return val[0], grad.T

    hmc.upto_grad_log_target = vg
    cur, (cur_val, cur_grad) = th, vg(th, x, y)
    step = torch.full((C,), 0.02)
    n_steps = torch.full((C,), 4, dtype=torch.int32)
    state = tuner.init(step, dtype=torch.float32, device="cpu")
    state = state._replace(m=torch.full((C,), float(np.log(np.float32(10) * np.float32(0.02)))))
    chains = torch.arange(C)
    for t in range(iters):
        mom, u, _ = kernel_prng.hmc_draws(seed, chains, t, model.num_params)
        mom = mom.T
        pos, pmom, val, grad = hmc.leapfrog(cur, mom, cur_grad, step, n_steps, x, y)
        rate = torch.clamp(torch.exp(hmc.hamiltonian(-cur_val, mom)
                                     - hmc.hamiltonian(-val, pmom)), max=1.0)
        accept = u < rate
        cur = torch.where(accept[:, None], pos, cur)
        cur_val = torch.where(accept, val, cur_val)
        cur_grad = torch.where(accept[:, None], grad, cur_grad)
        if t < burnin:
            state, step, n = tuner.tune(state, torch.where(torch.isnan(rate), 0.0, rate), t,
                                        t != burnin - 1)
            n_steps = torch.clamp(n, max=64)
        else:
            torch.testing.assert_close(samples[t - burnin], cur, rtol=1e-4, atol=1e-4)
    # e_w = it ** -k on the host against exp(-k log it) in float32: a few ulps
    torch.testing.assert_close(info["step"], step, rtol=3e-5, atol=0)
    assert torch.equal(info["num_steps"], n_steps)
    assert len(set(n_steps.tolist())) > 1  # the chains tuned apart
    torch.testing.assert_close(final, cur, rtol=1e-4, atol=1e-4)


def test_per_chain_without_l_keeps_the_trajectory():
    model, x, y = problem("xor")
    fn = make_resident_hmc_dense(model, x, y, 0.1, 7, 20, 15, chain_block=1024,
                                 tuner=HMCDATuner(d=0.65), tuner_mode="per_chain", device="cpu")
    _, info = fn.plain(1, theta0s(1024, 9, seed=3))
    assert bool((info["num_steps"] == 7).all())
    assert info["evaluations"] == 1024 * (1 + 7 * 20)
    assert len(set(info["step"].tolist())) > 1


def test_raw_outputs_dense_input_and_samples_buf():
    model, x, y = problem("xor")
    C, P = 2048, 9
    th = theta0s(C, P, seed=5)
    kw = dict(num_iters=9, num_burnin_iters=3, chain_block=1024, record_extras=True,
              device="cpu")
    samples, final, acc, vals, flags = make_resident_hmc_dense(model, x, y, 0.2, 5, **kw)(2, th)
    raw_fn = make_resident_hmc_dense(model, x, y, 0.2, 5, unstack_outputs=False, **kw)
    raw = raw_fn(2, th)
    assert [tuple(r.shape) for r in raw] == [(6, (P + 2) * 8, C // 8), (P * 8, C // 8),
                                             (8, C // 8)]
    un = unstack_chains(raw[0], P + 2)
    assert torch.equal(un[..., :P], samples) and torch.equal(un[..., P], vals)
    assert torch.equal(unstack_chains(raw[1], P), final)
    assert torch.equal(raw[2].reshape(-1), acc)
    assert torch.equal(flags, un[..., P + 1].int())
    # dense tiles in, the same run; a buffer of the raw shape is written in place
    buf = torch.full_like(raw[0], float("nan"))
    again = raw_fn(2, stack_chains(th), samples_buf=buf)
    assert again[0].data_ptr() == buf.data_ptr() and torch.equal(buf, raw[0])
    assert torch.equal(raw_fn(2, stack_chains(th), dense_input=True)[1], raw[1])


def test_value_errors_mirror_the_jax_package():
    model, x, y = problem("xor")
    with pytest.raises(ValueError, match="1024"):
        make_resident_hmc_dense(model, x, y, step=0.05, num_steps=10, num_iters=16,
                                chain_block=512, device="cpu")
    fn = make_resident_hmc_dense(model, x, y, step=0.05, num_steps=10, num_iters=16,
                                 chain_block=1024, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        fn(0, torch.zeros(1536, model.num_params))
    with pytest.raises(ValueError, match="ambiguous"):
        fn(0, torch.zeros(72, 9))  # [P*8, P]
    with pytest.raises(ValueError, match="P\\*8"):
        fn(0, torch.zeros(64, 16), dense_input=True)
    make_resident_hmc_dense(model, x, y, step=0.5, num_steps=10, num_iters=64,
                            tuner=HMCDATuner(l=0.5), device="cpu")
    make_resident_hmc_dense(model, x, y, step=0.5, num_steps=10, num_iters=64,
                            tuner=HMCDATuner(d=0.65), tuner_mode="per_chain", device="cpu")
    make_resident_hmc_dense(model, x, y, step=0.5, num_steps=10, num_iters=64,
                            tuner=HMCDATuner(l=0.5, d=0.65), tuner_mode="per_chain",
                            device="cpu")
    with pytest.raises(ValueError, match="tuner_mode"):
        make_resident_hmc_dense(model, x, y, step=0.5, num_steps=10, num_iters=64,
                                tuner=HMCDATuner(), tuner_mode="per_lane", device="cpu")
    with pytest.raises(ValueError, match="l_rounding"):
        make_resident_hmc_dense(model, x, y, 0.5, 10, 64, l_rounding="up", device="cpu")
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    iris, _, _ = problem("iris30")
    with pytest.raises(ValueError, match="MAX_DENSE_ROWS"):
        make_resident_hmc_dense(iris, ds.x, ds.y, 0.02, 5, 10, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        resident_hmc_dense.resident_hmc_dense(None, torch.zeros(9, 1024),
                                              resident_hmc.ResidentHMCParams(), 256, 1)
    assert resident_hmc_dense.launch_counts[resident_hmc_dense.KERNEL] == 0


@pytest.mark.parametrize("max_threads,chain_block,grouped,holds,want", [
    (640, 8192, True, 16, (512, 16)),    # XOR HMC at 88 registers: a cluster of 16
    (1024, 8192, True, 16, (1024, 8)),   # a portable cluster of 8 when 1024 threads fit
    (640, 1024, True, 16, (512, 2)),
    (384, 4096, True, 16, (256, 16)),    # 153 registers: 8192 would need 32 blocks
    (384, 8192, True, 16, None),
    (640, 8192, True, 8, None),          # the card holds no cluster of 16
    (640, 8192, False, 16, (256, 1)),    # untuned and per-chain runs share nothing
])
def test_launch_shape(max_threads, chain_block, grouped, holds, want):
    resources = {"registers": 65536 // max_threads, "max_threads_per_block": max_threads}

    def max_clusters(threads, blocks):
        return 4 if blocks <= holds else 0

    if want is None:
        with pytest.raises(ValueError, match="does not fit"):
            launch_shape(resources, max_clusters, chain_block, grouped)
    else:
        assert launch_shape(resources, max_clusters, chain_block, grouped) == want


@pytest.mark.parametrize("dense", [True, False])
def test_each_call_reports_its_evaluations(dense):
    """What a call leaves in ``last_info`` (the kernel's device counter on
    the card; the plain version's count here) equals the plain version's
    count, 1 + the leapfrog steps of each chain, with a tuned l-rule."""
    model, x, y = problem("xor")
    maker, module = ((make_resident_hmc_dense, resident_hmc_dense) if dense
                     else (make_resident_hmc, resident_hmc))
    fn = maker(model, x, y, 0.1, 10, 30, 20, chain_block=1024, tuner=HMCDATuner(l=0.4),
               device="cpu")
    th = theta0s(1024, 9, seed=6)
    fn(8, th)
    got = module.last_info[module.KERNEL]["evaluations"]
    (_, _, _), info = fn.plain(8, th)
    assert int(got) == info["evaluations"]
    # the 10 post-burn-in iterations run the frozen num_steps of each chain
    longer = maker(model, x, y, 0.1, 10, 31, 20, chain_block=1024, tuner=HMCDATuner(l=0.4),
                   device="cpu").plain(8, th)[1]
    assert longer["evaluations"] - info["evaluations"] == int(info["num_steps"].sum())
