"""Port, the SMC mutation pass: ``ops/resident_smc.py``, what CPU tensors
run and what ``csrc/resident_smc.cu`` is held against on the card by
``chip_smoke.py``. The plain pass equals an explicit loop on the walk stream
(``kernel_prng.walk_draws``) written per particle on the model's own
autograd log-prior and log-likelihood, with the MH proposal ``sqrt(step) z``
(float32: 1e-5 relative, 2e-4 absolute on iris values of about 1e2; counts
exact), and its ``pot`` is the split ``ll`` of its final particles. A numpy
float64 interpreter of ``mlp_vg.cuh::chain_eval_split``'s algebra equals the
JAX package's ``make_vg(split=True)`` (1e-10); the generic-target vg equals
JAX's ``make_generic_vg`` (float64: 1e-10); the makers and the wrapper check
their arguments."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.models import DistributionModel as JDistributionModel
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.ops import mlp_math as jmlp_math
from eeyore_tpu.ops.resident_smc import make_generic_vg as jmake_generic_vg
from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, DistributionModel, loss_functions, mlp
from eeyore_tpu_torch.ops import kernel_prng, resident_smc
from eeyore_tpu_torch.ops.mlp_math import extract_arch, make_vg, prepare_data

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])
F32 = dict(rtol=1e-5, atol=2e-4)


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


def theta0s(N, P, seed=0, scale=0.5):
    return torch.as_tensor(scale * np.random.default_rng(seed).normal(size=(N, P)),
                           dtype=torch.float32)


def explicit_loop(model, x, y, mutation, step, beta, th, seed, num_steps):
    """The mutation pass particle-batched on the model's autograd log-prior
    and log-likelihood: (final [N, P], accept counts [N])."""
    tx, ty = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    N, P = th.shape
    f32 = np.float32
    half, sq, half_inv = (float(f32(0.5 * step)), float(f32(math.sqrt(step))),
                          float(f32(0.5 / step)))
    beta = float(f32(beta))

    def target(theta):
        return model.log_prior(theta) + beta * model.log_lik(theta, tx, ty)

    def value_and_grad(theta):
        with torch.enable_grad():
            theta = theta.detach().requires_grad_(True)
            val = target(theta)
            (grad,) = torch.autograd.grad(val.sum(), theta)
        return val.detach(), grad

    theta = th.clone()
    if mutation == "MALA":
        val, grad = value_and_grad(theta)
    else:
        val = target(theta)
    counts = torch.zeros(N)
    for s in range(num_steps):
        z, u = kernel_prng.walk_draws(seed, torch.arange(N), s, P)
        z = z.T
        if mutation == "MALA":
            prop = (theta + half * grad) + sq * z
            v_p, g_p = value_and_grad(prop)
            d = theta - (prop + half * g_p)
            log_rate = (v_p - val) - half_inv * (d * d).sum(1) + 0.5 * (z * z).sum(1)
        else:
            prop = theta + sq * z
            v_p = target(prop)
            log_rate = v_p - val
        accept = torch.log(u) < log_rate
        theta = torch.where(accept[:, None], prop, theta)
        val = torch.where(accept, v_p, val)
        if mutation == "MALA":
            grad = torch.where(accept[:, None], g_p, grad)
        counts += accept.float()
    return theta, counts


def split_ll(model, x, y, theta):
    arrays = prepare_data(model, x, y)
    vg = make_vg(model, *arrays[:6], 1.0, with_grad=False, split=True)
    return vg(theta.T.contiguous(), *[torch.as_tensor(a) for a in arrays[:5]])[0][0]


@pytest.mark.parametrize("name,mutation,step,beta", [
    ("xor", "MALA", 0.05, 0.3), ("xor", "MH", 0.1, 1.0), ("iris", "MALA", 0.003, 0.3),
    ("iris", "MH", 0.01, 1.0)])
def test_plain_pass_equals_an_explicit_loop(name, mutation, step, beta):
    model, x, y = problem(name)
    fn = resident_smc.make_resident_smc_mutation(model, x, y, step, 4, chain_block=128,
                                                  mutation=mutation, device="cpu")
    th = theta0s(256, model.num_params, seed=1)
    final, pot, acc = fn(12345, beta, th)
    want, counts = explicit_loop(model, x, y, mutation, step, beta, th, 12345, 4)
    torch.testing.assert_close(final, want, **F32)
    torch.testing.assert_close(acc, counts, rtol=0, atol=0)
    assert 0 < float(acc.sum()) < 4 * 256
    torch.testing.assert_close(pot, split_ll(model, x, y, final), rtol=1e-6, atol=1e-5)
    (pfinal, ppot, pacc), info = fn.plain(12345, beta, th)
    assert torch.equal(pfinal, final) and torch.equal(ppot, pot) and torch.equal(pacc, acc)
    assert info["evaluations"] == 256 * 5


def test_transposed_layout_and_zero_steps():
    model, x, y = problem("xor")
    fn = resident_smc.make_resident_smc_mutation(model, x, y, 0.05, 3, chain_block=128,
                                                  device="cpu")
    th = theta0s(128, 9, seed=2)
    final, pot, acc = fn(7, 0.5, th)
    tfinal, tpot, tacc = fn.transposed(7, 0.5, th.T)
    assert torch.equal(tfinal, final.T) and torch.equal(tpot, pot) and torch.equal(tacc, acc)
    still = resident_smc.make_resident_smc_mutation(model, x, y, 0.05, 0, chain_block=128,
                                                     device="cpu")
    final, pot, acc = still(7, 0.5, th)
    assert torch.equal(final, th) and not acc.any()
    torch.testing.assert_close(pot, split_ll(model, x, y, th), rtol=1e-6, atol=1e-5)


def test_stage_seeds_wrap_to_int32():
    assert resident_smc.stage_seed(5, 1) == 5 + 7919
    top = 2 ** 31 - 1
    s = resident_smc.stage_seed(top, 50)
    assert -2 ** 31 <= s < 0 and (s & kernel_prng.MASK32) == (top + 7919 * 50) % 2 ** 32
    # the plain pass reads the seed's bits as the kernel does
    a = kernel_prng.walk_draws(s, torch.arange(4), 0, 3)[0]
    b = kernel_prng.walk_draws(s & kernel_prng.MASK32, torch.arange(4), 0, 3)[0]
    assert torch.equal(a, b)


def test_params_round_the_step_from_float64():
    pr = resident_smc.smc_params(0.003, 5, n_rows=152, prior_const=-1.5)
    assert pr.sqrt_step == float(np.float32(math.sqrt(0.003)))
    assert pr.half_step == float(np.float32(0.0015))
    assert pr.half_inv_step == float(np.float32(0.5 / 0.003))
    assert (pr.num_steps, pr.n_rows, pr.prior_const) == (5, 152, -1.5)


def chain_eval_split_numpy(model, arrays, beta, th):
    """``mlp_vg.cuh::chain_eval_split`` for one chain, transliterated in
    float64: the row loop's forward pass, output deltas and backward pass,
    then the prior; returns (ll, lp, beta * gll + glp)."""
    dims, bias, loss_kind, offsets = extract_arch(model)
    x, y, mask, loc, ivar, prior_const = arrays
    L = len(dims) - 1
    g = np.zeros(model.num_params)
    ll = 0.0
    for r in range(x.shape[0]):
        acts, weights = [x[r]], []
        for l in range(L):
            w_off, b_off = offsets[l]
            w = th[w_off:w_off + dims[l] * dims[l + 1]].reshape(dims[l + 1], dims[l])
            z = w @ acts[l] + (th[b_off:b_off + dims[l + 1]] if bias[l] else 0.0)
            weights.append(w)
            z_out = z
            acts.append(z if (l == L - 1 and loss_kind == "ce") else 1.0 / (1.0 + np.exp(-z)))
        m, yr = mask[r, 0], y[r]
        if loss_kind == "ce":
            e = np.exp(z_out - z_out.max())
            ll += (yr @ z_out - (z_out.max() + np.log(e.sum()))) * m
            delta = (yr - e / e.sum()) * m
        else:
            softplus = np.maximum(z_out, 0.0) + np.log1p(np.exp(-np.abs(z_out)))
            ll += np.sum((yr * z_out - softplus) * m)
            delta = (yr - acts[L]) * m
        for l in reversed(range(L)):
            w_off, b_off = offsets[l]
            g[w_off:w_off + dims[l] * dims[l + 1]] += np.outer(delta, acts[l]).ravel()
            if bias[l]:
                g[b_off:b_off + dims[l + 1]] += delta
            if l > 0:
                delta = (weights[l].T @ delta) * acts[l] * (1.0 - acts[l])
    diff = th - loc[:, 0]
    lp = np.sum(-0.5 * diff * diff * ivar[:, 0]) + prior_const
    return ll, lp, -diff * ivar[:, 0] + beta * g


@pytest.mark.parametrize("name", ["xor", "iris"])
def test_split_evaluation_algebra_equals_jax(name):
    model, x, y = problem(name)
    jmodel = (JMLP(loss=jloss_functions["binary_classification"], dtype=jnp.float64,
                   hparams=jmlp.Hyperparameters(dims=[2, 2, 1])) if name == "xor" else
              JMLP(loss=jloss_functions["multiclass_classification"], dtype=jnp.float64,
                   hparams=jmlp.Hyperparameters(dims=[4, 3, 3],
                                                activations=[jmlp.sigmoid, None])))
    jarrays = jmlp_math.prepare_data(jmodel, x, y)
    data = [np.asarray(a, np.float64) for a in jarrays[:5]]
    prior_const = jarrays[5]
    vg = jmlp_math.make_vg(jmodel, *data, prior_const, 1.0, with_grad=True, split=True)
    theta = np.random.default_rng(3).normal(size=(model.num_params, 5))
    ll, lp, gll, glp = (np.asarray(a) for a in vg(jnp.asarray(theta), *map(jnp.asarray, data)))
    for beta in (0.0, 0.3, 1.0):
        for c in range(theta.shape[1]):
            got = chain_eval_split_numpy(model, data + [prior_const], beta, theta[:, c])
            np.testing.assert_allclose(got[0], ll[0, c], rtol=1e-10, atol=1e-10)
            np.testing.assert_allclose(got[1], lp[0, c], rtol=1e-10, atol=1e-10)
            np.testing.assert_allclose(got[2], glp[:, c] + beta * gll[:, c], rtol=1e-10,
                                       atol=1e-10)


PREC = np.array([[1.0, 0.5], [0.5, 1.0]])


@pytest.mark.parametrize("with_grad", [True, False])
def test_generic_vg_equals_jax(with_grad):
    """The closure's vg against JAX's on the same float64 particles:
    ll = log target - log base, lp = log base, and their gradients."""
    prec = torch.as_tensor(PREC)
    port = DistributionModel(lambda t, x, y: -0.5 * (((t - 1.0) @ prec) * (t - 1.0)).sum(-1), 2,
                             device="cpu")
    ref = JDistributionModel(lambda t, x, y: -0.5 * (t - 1.0) @ jnp.asarray(PREC) @ (t - 1.0),
                             num_params=2)
    empty = np.zeros((1, 0))
    vg = resident_smc.make_generic_vg(port, empty, empty, lambda t: (-0.5 * t * t / 9.0).sum(-1),
                                      with_grad, device="cpu")
    jvg = jmake_generic_vg(ref, empty, empty, lambda t: jnp.sum(-0.5 * t * t / 9.0), with_grad)
    theta = np.random.default_rng(4).normal(size=(2, 8))
    got = vg(torch.as_tensor(theta))
    want = jvg(jnp.asarray(theta))
    assert len(got) == len(want) == (4 if with_grad else 2)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)


def test_closure_target_runs_the_plain_pass_on_cpu_tensors():
    """A DistributionModel with a base mutates on its closure by autograd,
    on the walk stream, and launches no kernel on CPU tensors."""
    dm = DistributionModel(lambda t, x, y: -0.5 * (t * t).sum(-1), 2, device="cpu")
    base = lambda t: (-0.5 * t * t / 9.0).sum(-1)  # noqa: E731
    fn = resident_smc.make_resident_smc_mutation(dm, np.zeros((1, 0)), np.zeros((1, 0)), 0.5,
                                                  3, chain_block=128, base_log_pdf=base,
                                                  device="cpu")
    before = dict(resident_smc.launch_counts)
    th = theta0s(128, 2, seed=5, scale=2.0)
    final, pot, acc = fn(3, 0.4, th)
    assert resident_smc.launch_counts == before and fn.eval_work is None
    torch.testing.assert_close(pot, -0.5 * (final * final).sum(1) - base(final), rtol=1e-5,
                               atol=1e-5)
    assert 0 < float(acc.sum()) < 3 * 128


def test_makers_and_the_wrapper_check_their_arguments():
    model, x, y = problem("xor")
    with pytest.raises(ValueError, match="MALA or MH"):
        resident_smc.make_resident_smc_mutation(model, x, y, 0.1, 2, mutation="HMC",
                                                device="cpu")
    tempered = problem("xor", temperature=0.5)[0]
    with pytest.raises(ValueError, match="untempered"):
        resident_smc.make_resident_smc_mutation(tempered, x, y, 0.1, 2, device="cpu")
    with pytest.raises(ValueError, match="init_sampler"):
        resident_smc.make_resident_smc(
            DistributionModel(lambda t, x, y: t.sum(-1), 2, device="cpu"), x, y, 128,
            base_log_pdf=lambda t: t.sum(-1), device="cpu")
    fn = resident_smc.make_resident_smc_mutation(model, x, y, 0.1, 2, chain_block=256,
                                                  device="cpu")
    with pytest.raises(ValueError, match="multiple of chain_block"):
        fn(0, 0.5, theta0s(128, 9))
    arrays = [torch.as_tensor(a) for a in prepare_data(model, x, y)[:5]]
    pr = resident_smc.smc_params(0.1, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        resident_smc.resident_smc(None, "MALA", theta0s(128, 9).T.contiguous(), *arrays, pr,
                                  128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        resident_smc.resident_smc_closure(None, "MALA", theta0s(128, 2).T.contiguous(), pr, 128)
