"""Port, the fixed-budget NUTS kernels' plain versions
(``ops/resident_nuts.py``, ``ops/resident_nuts_dense.py``): the NUTS stream
of ``kernel_prng.nuts_draws``, each plain version against an explicit loop of
the port's generic ``NUTS._tree_fixed`` fed that stream (with the kernels'
population tuner), the staged and dense versions against each other, the
makers' argument checks (JAX's, tests/test_ops.py), and the kernel path of
``sample_chains`` against JAX's scanned fixed-budget NUTS over 8 seeds. The
CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.datasets import as_schedule as jas_schedule
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.samplers import NUTS as JNUTS
from eeyore_tpu.samplers import sample_chains as jsample_chains
from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops import kernel_prng, resident_nuts, resident_nuts_dense
from eeyore_tpu_torch.ops.resident_hmc import _population_tune, group_index, group_means
from eeyore_tpu_torch.ops.resident_nuts import make_resident_nuts
from eeyore_tpu_torch.ops.resident_nuts_dense import make_resident_nuts_dense, metric_source
from eeyore_tpu_torch.samplers import NUTS
from eeyore_tpu_torch.samplers.dispatch import resolve_backend, run_kernel_backend
from eeyore_tpu_torch.tuners import HMCDATuner

XOR = (np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]]), np.array([[0.], [1.], [1.], [0.]]))



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread is many times faster than a pool
    on a shared machine (a 30-row ``make_vg`` call: 1.3 ms against 50)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def port_model(name, dtype=torch.float32):
    if name == "xor":
        return MLP(loss=loss_functions["binary_classification"], dtype=dtype, device="cpu",
                   hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
    return MLP(loss=loss_functions["multiclass_classification"], dtype=dtype, device="cpu",
               hparams=mlp.Hyperparameters(dims=[4, 3, 3], activations=[mlp.sigmoid, None]))


def iris30():
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    return ds.x[::5], ds.y[::5]  # 30 rows, every class


def prior_draws(P, C, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(C, P)), dtype=torch.float32)


def test_nuts_draws_follow_the_documented_words():
    P, D, C = 9, 3, 16
    chains = torch.arange(C, dtype=torch.int64)
    z, dirs, leaves, merges = kernel_prng.nuts_draws(5, chains, 7, P, D)
    assert torch.equal(z, kernel_prng.hmc_draws(5, chains, 7, P)[0])
    assert [u.shape for u in leaves] == [(1, C), (2, C), (4, C)]

    def word(j):
        return 1.0 - kernel_prng.uniform(kernel_prng.threefry2x32(5, chains, 7, j)[0])

    for d in range(D):
        first = (P + 1) // 2 + (1 << d) - 1 + 2 * d
        assert kernel_prng.nuts_word(P, d) == first
        assert torch.equal(dirs[d], word(first))
        for n in range(1 << d):
            assert torch.equal(leaves[d][n], word(first + 1 + n))
        assert torch.equal(merges[d], word(first + 1 + (1 << d)))
    assert float(dirs.min()) >= 0.0 and float(dirs.max()) < 1.0


def loop_reference(model, x, y, seed, theta0s, step, D, num_iters, burnin=0, thin=1,
                   tuner=None, chain_block=None, sublanes=1, inv_mass=None):
    """The generic fixed-budget tree of every chain, fed the NUTS stream,
    with the kernels' population tuner: (samples [kept, C, P], final [C, P],
    accept sums, divergence sums, values [kept, C], moved [kept, C])."""
    kernel = NUTS(model, step=step, max_depth=D, fixed_budget=True)
    dtype = model.dtype
    X, Y = (torch.as_tensor(a, dtype=dtype) for a in (x, y))
    C, P = theta0s.shape
    state = kernel.init(theta0s.to(dtype), X, Y)
    if inv_mass is not None:
        state = state._replace(inv_mass=torch.as_tensor(
            np.asarray(inv_mass, np.float32), dtype=dtype).expand(C, P).contiguous())
    steps = torch.full((C,), step, dtype=torch.float32)
    pr = resident_nuts.nuts_params(step, num_iters, burnin, thin, tuner, False, chain_block or C,
                                   sublanes)
    groups = C // (chain_block or C)
    barh, logbare = torch.zeros(groups), torch.zeros(groups)
    gid = group_index(C, chain_block or C, sublanes)
    chains = torch.arange(C, dtype=torch.int64)
    rows, vals, moved = [], [], []
    acc, div = torch.zeros(C), torch.zeros(C)
    for it in range(num_iters):
        z, dirs, leaf_u, merge_u = kernel_prng.nuts_draws(seed, chains, it, P, D)
        new, _ = kernel.step_fn(state._replace(step=steps.to(dtype)), X, Y, it,
                                momenta=z.T.to(dtype), directions=(dirs < 0.5).T,
                                leaf_uniforms=[u.T.to(dtype) for u in leaf_u],
                                merge_uniforms=merge_u.T.to(dtype))
        if it >= burnin:
            acc += new.accept_stat.float()
            div += new.divergent
        if tuner is not None and it < burnin:
            stat = group_means(new.accept_stat.float(), chain_block, sublanes)
            barh, logbare, new_step = _population_tune(pr, it, barh, logbare,
                                                       torch.nan_to_num(stat, nan=0.0))
            steps = new_step[gid]
        if it >= burnin and (it - burnin) % thin == 0:
            rows.append(new.sample)
            vals.append(new.target_val)
            moved.append(torch.any(new.sample != state.sample, dim=-1).to(torch.int32))
        state = new
    return (torch.stack(rows), state.sample, acc, div, torch.stack(vals), torch.stack(moved))


CASES = {
    "untuned": dict(),
    "tuned": dict(tuner=HMCDATuner(d=0.8), burnin=4),
    "thin2": dict(burnin=2, thin=2),
    "extras": dict(burnin=1),
    "metric": dict(inv_mass=np.linspace(0.4, 2.5, 9)),
}


def per_chain_close(got, want, tol=1e-5):
    """Every chain of [..., C, P] / [C] outputs within tol."""
    assert got.shape == want.shape
    diff = (got.double() - want.double()).abs()
    assert float(diff.max()) <= tol, float(diff.max())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dense", [False, True])
def test_plain_equals_the_generic_tree_fed_the_stream(dense, case):
    kw = dict(CASES[case])
    tuner, burnin, thin = kw.pop("tuner", None), kw.pop("burnin", 0), kw.pop("thin", 1)
    inv_mass = kw.pop("inv_mass", None)
    model = port_model("xor")
    C, D, iters, step = 1024, 3, 8, 0.3
    block = 1024 if dense else 256
    theta0s = prior_draws(model.num_params, C, 3)
    maker = make_resident_nuts_dense if dense else make_resident_nuts
    fn = maker(model, *XOR, step, D, iters, num_burnin_iters=burnin, chain_block=block,
               record_thin=thin, tuner=tuner, inv_mass=inv_mass, record_extras=case == "extras",
               device="cpu")
    before = dict(resident_nuts.launch_counts, **resident_nuts_dense.launch_counts)
    out = fn(11, theta0s)
    assert dict(resident_nuts.launch_counts, **resident_nuts_dense.launch_counts) == before
    want = loop_reference(model, *XOR, 11, theta0s, step, D, iters, burnin, thin, tuner,
                          block, 8 if dense else 1, inv_mass)
    for got, ref in zip(out[:4], want[:4]):
        per_chain_close(got, ref)
    if case == "extras":
        per_chain_close(out[4], want[4], tol=1e-4)
        assert out[5].dtype == torch.int32 and torch.equal(out[5], want[5])
    assert out[0].shape == ((iters - burnin) // thin, C, model.num_params)
    if case == "tuned":
        steps = fn.plain(11, theta0s)[1]["step"]
        assert len(torch.unique(steps)) == C // block and not torch.all(steps == step)


def test_plain_on_iris_equals_the_generic_tree():
    """30-row iris, tuned, against the generic tree in float64: within 1e-4,
    the float32 rounding of the plain version's sums over the rows (a
    float32 generic tree parts from both by as much)."""
    x, y = iris30()
    theta0s = 0.5 * prior_draws(27, 128, 4)
    fn = make_resident_nuts(port_model("iris"), x, y, 0.02, 3, 4, chain_block=128,
                            tuner=HMCDATuner(d=0.8), num_burnin_iters=2, device="cpu")
    want = loop_reference(port_model("iris", torch.float64), x, y, 2, theta0s, 0.02, 3, 4,
                          burnin=2, tuner=HMCDATuner(d=0.8), chain_block=128)
    for got, ref in zip(fn(2, theta0s)[:4], want[:4]):
        per_chain_close(got, ref, tol=1e-4)


@pytest.mark.parametrize("kw", [dict(), dict(inv_mass=np.linspace(0.4, 2.5, 9)),
                                dict(record_extras=True, record_thin=2, num_burnin_iters=2)])
def test_staged_and_dense_plain_agree_per_chain_on_xor(kw):
    model = port_model("xor")
    theta0s = prior_draws(model.num_params, 2048, 5)
    a = make_resident_nuts(model, *XOR, 0.2, 3, 6, chain_block=256, device="cpu", **kw)(9, theta0s)
    b = make_resident_nuts_dense(model, *XOR, 0.2, 3, 6, chain_block=1024, device="cpu",
                                 **kw)(9, theta0s)
    for got, want in zip(a, b):
        per_chain_close(got, want)


@pytest.mark.parametrize("module, maker, block", [
    (resident_nuts, make_resident_nuts, 256),
    (resident_nuts_dense, make_resident_nuts_dense, 1024)])
def test_last_info_keeps_each_chains_final_step(module, maker, block):
    """A call leaves each chain's final (tuned) step in the module's
    ``last_info``, the plain version's own ``info["step"]``: one step a
    tuning group, moved from the start by the burn-in."""
    model = port_model("xor")
    C, step = 2048, 0.2
    theta0s = prior_draws(model.num_params, C, 7)
    fn = maker(model, *XOR, step, 3, 6, num_burnin_iters=3, chain_block=block,
               tuner=HMCDATuner(d=0.8), device="cpu")
    out = fn(4, theta0s)
    info = module.last_info[module.KERNEL]
    plain_out, plain_info = fn.plain(4, theta0s)
    assert torch.equal(info["step"], plain_info["step"])
    assert torch.equal(info["accept_sums"], out[2]) and torch.equal(info["divergent_sums"], out[3])
    gid = group_index(C, block, getattr(module, "SUBLANES", 1))
    for g in range(C // block):
        group = info["step"][gid == g]
        assert group.numel() == block and torch.all(group == group[0])
    assert not torch.any(info["step"] == np.float32(step))
    for got, want in zip(out, plain_out):
        assert torch.equal(got, want)


@pytest.mark.parametrize("maker", [make_resident_nuts, make_resident_nuts_dense])
def test_unit_metric_is_no_metric(maker):
    model = port_model("xor")
    theta0s = prior_draws(model.num_params, 1024, 6)
    kw = dict(chain_block=1024, device="cpu")
    plain = maker(model, *XOR, 0.5, 3, 5, **kw)(1, theta0s)
    ones = maker(model, *XOR, 0.5, 3, 5, inv_mass=np.ones(9), **kw)(1, theta0s)
    for a, b in zip(plain, ones):
        assert torch.equal(a, b)


def test_metric_source_folds_unit_entries():
    text = metric_source(np.ones(3, np.float32), np.ones(3, np.float32))
    assert "case" not in text and text.count("default: return 1.0f;") == 2
    text = metric_source(np.array([1.0, 0.25], np.float32), np.array([1.0, 2.0], np.float32))
    assert "case 1: return 0x1.0000000000000p-2f;" in text
    assert "case 1: return 0x1.0000000000000p+1f;" in text and "case 0" not in text


def test_makers_check_their_arguments():
    """JAX's maker checks (tests/test_ops.py::TestResidentNutsBuilders and
    tests/test_nuts.py::test_metric_kernel_maker_accepts_inv_mass), and the
    TPU schedule settings, which have no CUDA counterpart."""
    model = port_model("xor")
    P = model.num_params
    for maker in (make_resident_nuts, make_resident_nuts_dense):
        with pytest.raises(ValueError, match="max_depth"):
            maker(model, *XOR, step=0.1, max_depth=0, num_iters=8, device="cpu")
        with pytest.raises(ValueError, match="trajectory"):
            maker(model, *XOR, step=0.1, max_depth=3, num_iters=8, tuner=HMCDATuner(l=0.5),
                  device="cpu")
        with pytest.raises(ValueError, match="positive"):
            maker(model, *XOR, step=0.1, max_depth=3, num_iters=8, inv_mass=np.zeros(P),
                  device="cpu")
    with pytest.raises(ValueError, match="chain_block"):
        make_resident_nuts_dense(model, *XOR, step=0.1, max_depth=3, num_iters=8, chain_block=512,
                                 device="cpu")
    fn = make_resident_nuts_dense(model, *XOR, step=0.1, max_depth=3, num_iters=8,
                                  chain_block=1024, inv_mass=np.ones(P), device="cpu")
    with pytest.raises(ValueError, match="chains"):
        fn(0, torch.zeros((512, P)))
    fn = make_resident_nuts(model, *XOR, step=0.1, max_depth=3, num_iters=8, chain_block=256,
                            inv_mass=np.full(P, 0.5), device="cpu")
    with pytest.raises(ValueError, match="chains"):
        fn(0, torch.zeros((100, P)))
    with pytest.raises(ValueError, match="TPU schedule"):
        make_resident_nuts(model, *XOR, step=0.1, max_depth=3, num_iters=8, stream=True,
                           device="cpu")


def test_wrappers_launch_on_cuda_tensors_only():
    cpu = torch.zeros((9, 256))
    params = resident_nuts.nuts_params(0.1, 4, 0, 1, None, False, 256, 1)
    with pytest.raises(ValueError, match="CUDA"):
        resident_nuts.resident_nuts(None, cpu, *(torch.zeros(8, 1),) * 5, torch.ones(9),
                                    torch.ones(9), params, 256, 1)
    with pytest.raises(ValueError, match="CUDA"):
        resident_nuts_dense.resident_nuts_dense(None, cpu, params, 256, 1)


# ---- the kernel path against JAX's scanned fixed-budget NUTS ----

def jax_model(name):
    if name == "xor":
        return JMLP(loss=jloss_functions["binary_classification"],
                    hparams=jmlp.Hyperparameters(dims=[2, 2, 1]))
    return JMLP(loss=jloss_functions["multiclass_classification"],
                hparams=jmlp.Hyperparameters(dims=[4, 3, 3], activations=[jmlp.sigmoid, None]))


def pooled(samples):
    """(pooled mean [P], its standard error [P]) over chains [C, kept, P]."""
    means = np.asarray(samples, np.float64).mean(axis=1)
    return means.mean(axis=0), means.std(axis=0, ddof=1) / np.sqrt(means.shape[0])


@pytest.mark.parametrize("name", ["xor", "iris"])
def test_kernel_path_agrees_with_jax_over_seeds(name):
    """8 seeds: the plain kernel through dispatch (dense on XOR, staged on
    30-row iris) and JAX's scanned fixed-budget NUTS, at the same step and
    depth: pooled means within 5 pooled standard errors, mean accept_stat
    within 0.02."""
    x, y = XOR if name == "xor" else iris30()
    step, D, iters, burnin = (0.3, 3, 60, 30) if name == "xor" else (0.03, 3, 60, 30)
    C, jC = (1024, 256) if name == "xor" else (128, 128)
    model, jm = port_model(name), jax_model(name)
    P = model.num_params
    kernel = NUTS(model, step=step, max_depth=D, fixed_budget=True)
    plan, reason = resolve_backend(kernel, (x, y), C, iters, burnin, platform="cuda",
                                   backend="auto" if name == "xor" else "resident")
    assert plan is not None, reason
    assert plan.backend == ("dense" if name == "xor" else "resident")
    jkernel = JNUTS(jm, step=step, max_depth=D, fixed_budget=True)
    jdata = jas_schedule((jnp.asarray(x), jnp.asarray(y)))  # one schedule: one compile
    port_rows, jax_rows, port_acc, jax_acc = [], [], [], []
    for seed in range(8):
        recorded, info = run_kernel_backend(kernel, torch.Generator().manual_seed(seed),
                                            prior_draws(P, C, 100 + seed), (x, y), iters, burnin,
                                            plan)
        port_rows.append(recorded["sample"])
        port_acc.append(float(info["accept_counts"].mean()) / info["kept"])
        assert info["divergent_sums"].shape == (C,)
        rec = jsample_chains(jkernel, jax.random.PRNGKey(seed),
                             jnp.asarray(np.random.default_rng(200 + seed).normal(size=(jC, P))),
                             jdata, iters,
                             burnin, record_keys=("sample", "accept_stat"), return_arrays=True,
                             backend="scan")
        jax_rows.append(np.asarray(rec["sample"]))
        jax_acc.append(float(np.mean(rec["accept_stat"])))
    (m1, s1) = pooled(torch.cat(port_rows).numpy())
    (m2, s2) = pooled(np.concatenate(jax_rows))
    z = np.abs(m1 - m2) / np.sqrt(s1 ** 2 + s2 ** 2)
    assert z.max() < 5.0, z
    assert abs(np.mean(port_acc) - np.mean(jax_acc)) < 0.02, (np.mean(port_acc), np.mean(jax_acc))
