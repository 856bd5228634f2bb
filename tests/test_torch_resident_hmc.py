"""Port, whole-loop HMC: the plain version of ``resident_hmc`` (what CPU
tensors run, and what the CUDA kernel is held against on the card by
``chip_smoke.py``). Untuned runs equal an explicit loop of the port's
``HMC.leapfrog`` on the same Threefry draws (float32, 2e-4 on iris values of
~1e2, 1e-5 on XOR); the in-loop tuner matches ``HMCDATuner`` fed block-mean
rates (float32 against float64, 1e-5 relative); the recorded extras are
exact; and sampled runs agree with the JAX package's scanned path within 5
pooled standard errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.samplers import HMC as JHMC
from eeyore_tpu.samplers import sample_chains as jsample_chains
from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops import kernel_prng, resident_hmc
from eeyore_tpu_torch.ops.mlp_math import make_vg, prepare_data
from eeyore_tpu_torch.ops.resident_hmc import make_resident_hmc
from eeyore_tpu_torch.samplers import HMC
from eeyore_tpu_torch.tuners import HMCDATuner

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])


def problem(name, dtype=torch.float32):
    if name == "xor":
        model = MLP(loss=loss_functions["binary_classification"], dtype=dtype, device="cpu",
                    hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
        return model, XOR_X, XOR_Y
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    model = MLP(loss=loss_functions["multiclass_classification"], dtype=dtype, device="cpu",
                hparams=mlp.Hyperparameters(dims=[4, 3, 3], activations=[mlp.sigmoid, None]))
    return model, ds.x, ds.y


def theta0s(C, P, seed=0, scale=0.1):
    return torch.as_tensor(scale * np.random.default_rng(seed).normal(size=(C, P)),
                           dtype=torch.float32)


@pytest.mark.parametrize("name,step,num_steps,atol", [("xor", 0.6, 5, 1e-5),
                                                     ("iris", 0.02, 6, 2e-4)])
def test_untuned_run_equals_explicit_leapfrog_loop(name, step, num_steps, atol):
    """Momenta and accept uniforms from ``kernel_prng.hmc_draws`` (key =
    (seed, chain), counter = (iteration, j)) fed to ``HMC.leapfrog`` on the
    model's autograd give the same chains, accept counts and extras."""
    model, x, y = problem(name)
    C, iters, burnin, seed = 64, 12, 4, 7
    th = theta0s(C, model.num_params)
    fn = make_resident_hmc(model, x, y, step, num_steps, iters, burnin, chain_block=32,
                           record_extras=True, device="cpu")
    samples, final, acc, vals, flags = fn(seed, th)

    hmc = HMC(model)
    tx, ty = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    cur, (cur_val, cur_grad) = th, hmc.upto_grad_log_target(th, tx, ty)
    chains = torch.arange(C)
    n_acc = torch.zeros(C)
    for t in range(iters):
        mom, u, _ = kernel_prng.hmc_draws(seed, chains, t, model.num_params)
        mom = mom.T
        pos, pmom, val, grad = hmc.leapfrog(cur, mom, cur_grad, step, num_steps, tx, ty)
        rate = torch.clamp(torch.exp(hmc.hamiltonian(-cur_val, mom)
                                     - hmc.hamiltonian(-val, pmom)), max=1.0)
        accept = u < rate
        cur = torch.where(accept[:, None], pos, cur)
        cur_val = torch.where(accept, val, cur_val)
        cur_grad = torch.where(accept[:, None], grad, cur_grad)
        if t >= burnin:
            n_acc += accept
            torch.testing.assert_close(samples[t - burnin], cur, rtol=1e-5, atol=atol)
            torch.testing.assert_close(vals[t - burnin], cur_val, rtol=1e-5, atol=atol)
            assert torch.equal(flags[t - burnin].bool(), accept)
    torch.testing.assert_close(final, cur, rtol=1e-5, atol=atol)
    assert torch.equal(acc, n_acc)
    assert 0 < acc.sum() < C * (iters - burnin)


@pytest.mark.parametrize("eub", [None, 0.05])
def test_population_tuner_matches_hmcda_tuner(eub):
    """The in-loop update of each tuning group against ``HMCDATuner.tune``
    (float64) fed the same block-mean rates, with m = log(10 * step0) and
    the averaged step frozen at the last burn-in iteration."""
    burnin, groups, step0 = 25, 3, 0.1
    tuner = HMCDATuner(l=0.15, e0=0.02, eub=eub)
    f32 = np.float32
    pr = resident_hmc.ResidentHMCParams(
        num_burnin_iters=burnin, tuner_m=np.log(f32(10.0) * f32(step0)), d=tuner.d, g=tuner.g,
        t0=tuner.t0, k=tuner.k, log_eub=np.inf if eub is None else np.log(eub))
    rates = np.random.default_rng(4).uniform(0.2, 1.0, size=(burnin, groups))
    barh = logbare = torch.zeros(groups)
    state = tuner.init(torch.full((groups,), step0, dtype=torch.float64), dtype=torch.float64,
                       device="cpu")
    for t in range(burnin):
        mean_rate = torch.as_tensor(rates[t], dtype=torch.float32)
        barh, logbare, step = resident_hmc._population_tune(pr, t, barh, logbare, mean_rate)
        state, e, n = tuner.tune(state, torch.as_tensor(rates[t], dtype=torch.float32).double(),
                                 t, t != burnin - 1)
        np.testing.assert_allclose(step.numpy(), e.numpy(), rtol=1e-5)
        np.testing.assert_allclose(logbare.numpy(), state.logbare.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(step.numpy(), np.exp(state.logbare.numpy()), rtol=1e-5)


def test_tuned_run_freezes_the_step_and_rounds_the_trajectory():
    """Each group's chains share one step; after burn-in the step and
    trajectory length stay put and num_steps = clip(round(l/step), 1, 64)."""
    model, x, y = problem("xor")
    tuner = HMCDATuner(l=0.5, e0=0.02)
    fn = make_resident_hmc(model, x, y, 0.1, 10, 60, 40, chain_block=64, tuner=tuner,
                           device="cpu")
    th = theta0s(256, model.num_params, seed=1)
    (samples, _, acc), info = fn.plain(3, th)
    step = info["step"].reshape(4, 64)
    assert torch.equal(step, step[:, :1].expand(4, 64))
    assert len(set(step[:, 0].tolist())) == 4  # the groups tune apart
    torch.testing.assert_close(info["num_steps"],
                               torch.clamp(torch.round(0.5 / info["step"]), 1, 64).int())
    longer = make_resident_hmc(model, x, y, 0.1, 10, 61, 40, chain_block=64, tuner=tuner,
                               device="cpu").plain(3, th)[1]
    torch.testing.assert_close(longer["step"], info["step"], rtol=0, atol=0)
    # one more post-burn-in iteration costs num_steps evaluations per chain
    assert longer["evaluations"] - info["evaluations"] == int(info["num_steps"].sum())
    assert abs(acc.mean().item() / 20 - 0.65) < 0.2


def test_stochastic_rounding_freezes_floor_or_ceil_with_mean_l_over_e():
    model, x, y = problem("xor")
    tuner = HMCDATuner(l=3.0, e0=0.02)
    fn = make_resident_hmc(model, x, y, 0.1, 10, 31, 30, chain_block=1024, tuner=tuner,
                           l_rounding="stochastic", device="cpu")
    _, info = fn.plain(5, theta0s(4096, model.num_params, seed=2))
    ratio = (3.0 / info["step"]).double()
    n = info["num_steps"].double()
    lo = torch.floor(ratio)
    assert bool((lo >= 1).all())  # no chain at the clip to 1
    assert bool(((n == lo) | (n == lo + 1)).all())
    assert bool((n == lo).any()) and bool((n == lo + 1).any())
    # Bernoulli(frac) per chain: the mean is l / e within 5 standard errors
    frac = ratio - lo
    assert abs((n - ratio).mean().item()) < 5 * (frac * (1 - frac)).mean().sqrt().item() / 64


def test_record_thin_and_extras():
    """Thinning keeps every record_thin-th post-burn-in state (the first of
    each block); the moved flags are exact at any thinning and target_val is
    the log-target at the recorded sample."""
    model, x, y = problem("iris")
    C, seed = 32, 9
    th = theta0s(C, model.num_params, seed=3)
    full = make_resident_hmc(model, x, y, 0.02, 4, 14, 2, chain_block=32, record_extras=True,
                             device="cpu")(seed, th)
    thin = make_resident_hmc(model, x, y, 0.02, 4, 14, 2, chain_block=32, record_thin=3,
                             record_extras=True, device="cpu")(seed, th)
    plain = make_resident_hmc(model, x, y, 0.02, 4, 14, 2, chain_block=32, device="cpu")(seed, th)
    assert full[0].shape == (12, C, model.num_params) and thin[0].shape == (4, C, 27)
    assert len(plain) == 3 and torch.equal(plain[0], full[0])
    for a, b in zip(thin, full):
        if a.dim() >= 2 and a.shape[0] == 4:
            torch.testing.assert_close(a, b[::3], rtol=0, atol=0)
    torch.testing.assert_close(thin[1], full[1], rtol=0, atol=0)
    torch.testing.assert_close(thin[2], full[2], rtol=0, atol=0)
    samples, _, acc, vals, flags = full
    assert flags.dtype == torch.int32 and vals.shape == (12, C)
    moved = torch.any(samples[1:] != samples[:-1], dim=-1)
    assert torch.equal(flags[1:].bool(), moved)
    assert torch.equal(flags.sum(0).float(), acc)
    arrays = prepare_data(model, x, y)
    vg = make_vg(model, *arrays, with_grad=False)
    want = vg(samples.reshape(-1, 27).T.contiguous(), *[torch.as_tensor(a) for a in arrays[:5]])
    torch.testing.assert_close(vals.reshape(-1), want[0], rtol=1e-5, atol=1e-4)


def test_pooled_means_match_jax_scan_statistically():
    """XOR, HMC(step=0.1, num_steps=5), 256 chains, 400 iterations, 100
    burn-in: the plain resident run against JAX ``sample_chains(backend=
    "scan")``; pooled means within 5 pooled standard errors, acceptance
    within 0.03."""
    model, x, y = problem("xor")
    C = 256
    th = theta0s(C, model.num_params, seed=4)
    samples, _, acc = make_resident_hmc(model, x, y, 0.1, 5, 400, 100, chain_block=256,
                                        device="cpu")(11, th)
    jm = JMLP(loss=jloss_functions["binary_classification"], dtype=jnp.float64,
              hparams=jmlp.Hyperparameters(dims=[2, 2, 1]))
    jrec = jsample_chains(JHMC(jm, step=0.1, num_steps=5), jax.random.PRNGKey(0),
                          jnp.asarray(th.double().numpy()), (jnp.asarray(x), jnp.asarray(y)),
                          400, 100,
                          backend="scan", return_arrays=True, record_keys=("sample", "accepted"))
    port = samples.transpose(0, 1).double().mean(1).numpy()      # [C, P] chain means
    ref = np.asarray(jrec["sample"], dtype=np.float64).mean(1)
    se = np.sqrt(port.var(0, ddof=1) / C + ref.var(0, ddof=1) / C)
    assert np.all(np.abs(port.mean(0) - ref.mean(0)) <= 5 * se)
    assert abs(acc.mean().item() / 300 - np.asarray(jrec["accepted"]).mean()) < 0.03


def test_argument_checks():
    model, x, y = problem("xor")
    for knob in ("stream", "vmem_limit_bytes", "mxu_layer0", "matmul_precision"):
        with pytest.raises(ValueError, match="TPU schedule"):
            make_resident_hmc(model, x, y, 0.1, 5, 10, device="cpu", **{knob: True})
    with pytest.raises(ValueError, match="l_rounding"):
        make_resident_hmc(model, x, y, 0.1, 5, 10, l_rounding="up", device="cpu")
    # JAX's default tuning group of 2048 chains: the plain version takes any
    # group (on the card only a group no block or cluster holds raises)
    tuned = make_resident_hmc(model, x, y, 0.1, 5, 10, 5, tuner=HMCDATuner(l=0.5), device="cpu")
    samples, _, acc = tuned(0, torch.zeros(2048, model.num_params))
    assert samples.shape == (5, 2048, model.num_params) and torch.all(acc <= 5)
    with pytest.raises(ValueError, match="multiple of chain_block 2048"):
        tuned(0, torch.zeros(1024, model.num_params))
    fn = make_resident_hmc(model, x, y, 0.1, 5, 10, chain_block=64, device="cpu")
    with pytest.raises(ValueError, match="multiple of chain_block"):
        fn(0, torch.zeros(100, model.num_params))
    with pytest.raises(ValueError, match="CUDA tensors"):
        resident_hmc.resident_hmc(None, torch.zeros(9, 128), *[torch.zeros(1)] * 5,
                                  resident_hmc.ResidentHMCParams(), 128)
    assert resident_hmc.launch_counts[resident_hmc.KERNEL] == 0  # the CPU never launches


def test_build_name_carries_the_headers_hash(tmp_path, monkeypatch):
    """``load_library`` names a build after the headers it includes, so an
    edited ``csrc/*.cuh`` never loads a stale library."""
    from eeyore_tpu_torch.ops import _build

    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == [
        "kernel_prng.cuh", "lane_eval.cuh", "mlp_vg.cuh", "resident_loop.cuh"]
    (tmp_path / "a.cuh").write_text("// one")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.headers_hash()
    assert first == _build.headers_hash()
    (tmp_path / "a.cuh").write_text("// two")
    assert _build.headers_hash() != first


@pytest.mark.parametrize("dense", [False, True])
def test_plain_version_ignores_the_default_dtype(dense):
    """The plain version computes in float32 whatever ``torch``'s default
    dtype: under float64 its last-leapfrog factor once came out float64 and
    carried the momentum into float64, so the samples moved."""
    from eeyore_tpu_torch.ops.resident_hmc_dense import make_resident_hmc_dense

    ds = XYDataset.from_eeyore("xor")
    theta0s = torch.as_tensor(0.1 * np.random.default_rng(0).normal(size=(1024, 9)),
                              dtype=torch.float32)
    maker = make_resident_hmc_dense if dense else make_resident_hmc
    outputs = []
    default = torch.get_default_dtype()
    try:
        for dtype in (torch.float32, torch.float64):
            torch.set_default_dtype(dtype)
            model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                        device="cpu", hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
            outputs.append(maker(model, ds.x, ds.y, 0.05, 10, 6, chain_block=1024,
                                 device="cpu")(1, theta0s))
    finally:
        torch.set_default_dtype(default)
    for a, b in zip(*outputs):
        assert a.dtype == b.dtype and torch.equal(a, b)
