"""Port parity, generic NUTS: the port's batched ``NUTS`` against the JAX
package's one-chain ``NUTS`` vmapped over chains, in float64 on the same
numpy inputs and JAX's own random draws (momenta from the momentum key, and
per depth the direction, leaf and merge uniforms of the tree key). One
transition (adaptive and fixed-budget, with and without a metric, on a
bivariate normal and the XOR MLP) and a whole tuned burn-in with the metric
warmup are held to 1e-10; the depth probe's decision to JAX's on the same
recorded arrays; ``max_depth="auto"`` through the runner."""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eeyore_tpu.samplers.runner as jrunner
import eeyore_tpu_torch.samplers.nuts as tnuts
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import DistributionModel as JDistributionModel
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.samplers import NUTS as JNUTS
from eeyore_tpu.samplers import choose_max_depth as jchoose_max_depth
from eeyore_tpu.samplers.nuts import _popcount as j_popcount
from eeyore_tpu.samplers.nuts import _trailing_ones as j_trailing_ones
from eeyore_tpu.tuners.dual_averaging import HMCDATuner as JHMCDATuner
from eeyore_tpu_torch import convert
from eeyore_tpu_torch.models import MLP, DistributionModel, loss_functions, mlp
from eeyore_tpu_torch.samplers import NUTS, NUTSState, choose_max_depth, sample_chains
from eeyore_tpu_torch.samplers.nuts import _popcount, _trailing_ones
from eeyore_tpu_torch.tuners import DualAveragingState, HMCDATuner

F64_TOL = dict(rtol=1e-10, atol=1e-10)
XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])
EMPTY = np.zeros((1, 0))
STEP_FIELDS = ("sample", "target_val", "grad_val", "accept_stat", "depth", "num_leapfrogs",
               "divergent")



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread is many times faster than a pool
    on a shared machine (a 30-row ``make_vg`` call: 1.3 ms against 50)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def t(a):
    return torch.as_tensor(np.array(a))


def gaussian(cov):
    """(jax model, port model, x, y) of the zero-mean normal with ``cov``."""
    prec = np.linalg.inv(cov)
    jprec, tprec = jnp.asarray(prec), torch.as_tensor(prec)
    jm = JDistributionModel(lambda th, x, y: -0.5 * th @ jprec @ th, num_params=cov.shape[0])
    tm = DistributionModel(lambda th, x, y: -0.5 * ((th @ tprec) * th).sum(-1), cov.shape[0],
                           dtype=torch.float64, device="cpu")
    return jm, tm, EMPTY, EMPTY


def xor():
    jm = JMLP(loss=jloss_functions["binary_classification"], dtype=jnp.float64,
              hparams=jmlp.Hyperparameters(dims=[2, 2, 1]))
    tm = MLP(loss=loss_functions["binary_classification"], dtype=torch.float64, device="cpu",
             hparams=mlp.Hyperparameters(dims=[2, 2, 1]))
    return jm, tm, XOR_X, XOR_Y


PROBLEMS = {"normal": lambda: gaussian(np.array([[1.0, 0.7], [0.7, 1.0]])), "xor": xor}


@functools.lru_cache(maxsize=None)
def _jax_draw_fn(P, D):
    def one(key):
        key_mom, key_tree = jax.random.split(key)
        z = jax.random.normal(key_mom, (P,), dtype=jnp.float64)
        dirs, leaves, merges = [], [], []
        for d in range(D):
            k_dir, k_sub, k_merge = jax.random.split(jax.random.fold_in(key_tree, d), 3)
            dirs.append(jax.random.bernoulli(k_dir))
            leaves.append(jnp.stack([jax.random.uniform(jax.random.fold_in(k_sub, n),
                                                        dtype=jnp.float64)
                                     for n in range(2 ** d)]))
            merges.append(jax.random.uniform(k_merge, dtype=jnp.float64))
        return z, jnp.stack(dirs), leaves, jnp.stack(merges)

    return jax.jit(jax.vmap(one))


def jax_draws(keys, P, D):
    """JAX's draws of one NUTS transition per key, as the port's
    ``step_fn`` takes them: (momenta [C, P], directions [C, D] bool, leaf
    uniforms [D tensors of [C, 2**d]], merge uniforms [C, D])."""
    z, dirs, leaves, merges = _jax_draw_fn(P, D)(keys)
    return dict(momenta=t(z), directions=t(dirs), leaf_uniforms=[t(u) for u in leaves],
                merge_uniforms=t(merges))


def jax_stepper(kernel, x, y):
    return jax.jit(jax.vmap(lambda k, s, it: kernel.step_fn(k, s, x, y, it),
                            in_axes=(0, 0, None)))


def assert_state_close(tstate, jstate, fields):
    for f in fields:
        if f == "tuner":
            for g in DualAveragingState._fields:
                np.testing.assert_allclose(getattr(tstate.tuner, g).numpy(),
                                           np.asarray(getattr(jstate.tuner, g)), **F64_TOL)
        else:
            np.testing.assert_allclose(getattr(tstate, f).numpy(),
                                       np.asarray(getattr(jstate, f)), **F64_TOL, err_msg=f)


# ---- checkpoint combinatorics (ports of tests/test_nuts.py) ----

def test_popcount_and_trailing_ones_equal_jax():
    ns = np.arange(4096)
    np.testing.assert_array_equal(_popcount(t(ns)).numpy(),
                                  np.asarray(j_popcount(jnp.asarray(ns, jnp.int32))))
    np.testing.assert_array_equal(_trailing_ones(t(ns)).numpy(),
                                  np.asarray(j_trailing_ones(jnp.asarray(ns, jnp.int32))))
    assert _popcount(t(ns)).dtype == torch.int32


def test_check_ranges_cover_exactly_the_complete_subtrees():
    """Leaf n is stored at slot popcount(n) when even; an odd one checks
    slots [popcount(n) - trailing_ones(n), popcount(n)): the start leaves of
    the complete subtrees that end at n, whose slots no later store has
    clobbered."""
    max_leaves = 1024
    pcs = _popcount(torch.arange(max_leaves)).numpy()
    tos = _trailing_ones(torch.arange(max_leaves)).numpy()
    slot_of = {}
    for n in range(max_leaves):
        if n % 2 == 0:
            slot_of[n] = pcs[n]
            continue
        starts, m = [], 1
        while (n + 1) % (1 << m) == 0:
            starts.append(n - (1 << m) + 1)
            m += 1
        assert list(range(pcs[n] - tos[n], pcs[n])) == sorted(slot_of[s] for s in starts)
        live = {s: slot_of[s] for s in slot_of
                if s % 2 == 0 and any(s % (1 << mm) == 0 and s + (1 << mm) - 1 > n
                                      for mm in range(1, 11))}
        assert len(set(live.values())) == len(live), f"slot collision at leaf {n}"
    # trees of depth 10: even-leaf slots stay below max_depth - 1
    assert int(_popcount(torch.arange(0, 1 << 9, 2)).max()) <= 8


# ---- one transition with JAX's draws ----

@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("metric", [False, True])
@pytest.mark.parametrize("name", ["normal", "xor"])
def test_step_fn_matches_jax_given_draws(name, metric, fixed):
    """Four seeds of draws from one state of 16 chains at per-chain steps
    from 0.2 to 8, large enough to diverge."""
    jm, tm, x, y = PROBLEMS[name]()
    C, D = 16, 4
    rng = np.random.default_rng(11)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    thetas = rng.normal(size=(C, tm.num_params))
    steps = np.repeat([0.2, 0.5, 1.0, 8.0], C // 4)
    jk = JNUTS(jm, max_depth=D, fixed_budget=fixed)
    tk = NUTS(tm, max_depth=D, fixed_budget=fixed)
    js = jax.vmap(lambda th: jk.init(th, jx, jy))(jnp.asarray(thetas))
    ts = tk.init(t(thetas), t(x), t(y))
    js, ts = js._replace(step=jnp.asarray(steps)), ts._replace(step=t(steps))
    if metric:
        inv_mass = rng.uniform(0.3, 3.0, size=(C, tm.num_params))
        js, ts = js._replace(inv_mass=jnp.asarray(inv_mass)), ts._replace(inv_mass=t(inv_mass))
    stepper = jax_stepper(jk, jx, jy)
    divergent = 0
    for seed in range(4):
        keys = jax.random.split(jax.random.PRNGKey(seed), C)
        jnew, _ = stepper(keys, js, 0)
        tnew, tinfo = tk.step_fn(ts, t(x), t(y), 0, **jax_draws(keys, tm.num_params, D))
        assert_state_close(tnew, jnew, STEP_FIELDS)
        assert tinfo["depth"].dtype == torch.int32
        divergent += int(tnew.divergent.sum())
    assert divergent > 0


@pytest.mark.parametrize("step", [0.4, 5.0])
def test_adaptive_equals_fixed_budget_exactly(step):
    """Same draws, same max_depth: the same chains bit for bit, with and
    without divergences (the port's test_nuts.py::TestFixedBudget)."""
    _, tm, x, y = PROBLEMS["normal"]()
    C, D = 32, 4
    gen = torch.Generator().manual_seed(13)
    thetas = torch.randn((C, 2), generator=gen, dtype=torch.float64) + 2.0
    ada, fix = NUTS(tm, step=step, max_depth=D), NUTS(tm, step=step, max_depth=D,
                                                       fixed_budget=True)
    sa, sf = ada.init(thetas, t(x), t(y)), fix.init(thetas, t(x), t(y))
    for it in range(20):
        draws = dict(momenta=torch.randn((C, 2), generator=gen, dtype=torch.float64),
                     directions=torch.rand((C, D), generator=gen) < 0.5,
                     leaf_uniforms=[torch.rand((C, 2 ** d), generator=gen, dtype=torch.float64)
                                    for d in range(D)],
                     merge_uniforms=torch.rand((C, D), generator=gen, dtype=torch.float64))
        sa, _ = ada.step_fn(sa, t(x), t(y), it, **draws)
        sf, _ = fix.step_fn(sf, t(x), t(y), it, **draws)
        for f in STEP_FIELDS + ("accepted",):
            assert torch.equal(getattr(sa, f), getattr(sf, f)), (it, f)
    if step > 1.0:
        assert int(sf.divergent.sum()) > 0


def test_tuned_burn_in_with_metric_warmup_matches_jax():
    """24 tuned transitions with mass_adapt (Welford over [6, 12), the
    metric frozen at 11 with a warm restart of the tuner): step, metric,
    Welford and tuner state within 1e-10 of JAX's, iteration by iteration."""
    jm, tm, x, y = gaussian(np.diag([4.0, 0.25]))
    C, D, B = 8, 4, 24
    thetas = np.random.default_rng(2).normal(size=(C, 2))
    jk = JNUTS(jm, step=0.5, max_depth=D, tuner=JHMCDATuner(d=0.8), mass_adapt=True,
               num_burnin_iters=B)
    tk = NUTS(tm, step=0.5, max_depth=D, tuner=HMCDATuner(d=0.8), mass_adapt=True,
              num_burnin_iters=B)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    js = jax.vmap(lambda th: jk.init(th, jx, jy))(jnp.asarray(thetas))
    ts = convert.nuts_state_from_numpy(js, tm, device="cpu", dtype=torch.float64)
    stepper = jax_stepper(jk, jx, jy)
    for it in range(B + 2):
        keys = jax.random.split(jax.random.PRNGKey(100 + it), C)
        js, _ = stepper(keys, js, it)
        ts, _ = tk.step_fn(ts, t(x), t(y), it, **jax_draws(keys, 2, D))
        assert_state_close(ts, js, NUTSState._fields)
    assert not np.allclose(ts.inv_mass.numpy(), 1.0)
    assert int(ts.wf_n[0]) == B // 2 - B // 4


def test_nuts_state_round_trip_through_convert():
    jm, tm, x, y = xor()
    rng = np.random.default_rng(4)
    C, P = 6, tm.num_params
    jk = JNUTS(jm, step=0.3, max_depth=3, tuner=JHMCDATuner(e0=0.3))
    js = jax.vmap(lambda th: jk.init(th, jnp.asarray(x), jnp.asarray(y)))(
        jnp.asarray(rng.normal(size=(C, P))))
    ints = {f: jnp.asarray(rng.integers(0, 9, size=C), jnp.int32)
            for f in ("accepted", "depth", "num_leapfrogs", "divergent", "wf_n")}
    js = js._replace(accept_stat=jnp.asarray(rng.uniform(size=C)),
                     inv_mass=jnp.asarray(rng.uniform(0.5, 2.0, size=(C, P))),
                     wf_mean=jnp.asarray(rng.normal(size=(C, P))),
                     wf_m2=jnp.asarray(rng.uniform(size=(C, P))), **ints)
    ts = convert.nuts_state_from_numpy(js, tm, device="cpu", dtype=torch.float64)
    back = convert.to_numpy(ts)
    assert ts.depth.dtype == torch.int32 and ts.tuner.m.dtype == torch.float64
    for f in NUTSState._fields:
        if f == "tuner":
            for g in DualAveragingState._fields:
                np.testing.assert_array_equal(getattr(back.tuner, g), getattr(js.tuner, g))
        else:
            np.testing.assert_array_equal(getattr(back, f), np.asarray(getattr(js, f)))
    with pytest.raises(ValueError, match="parameters"):
        convert.nuts_state_from_numpy(js._replace(sample=js.sample[:, :2]), tm, device="cpu")


# ---- the depth probe ----

class _ProbeState(NamedTuple):
    step: object
    inv_mass: object


def probe_tables(C=8, kept=128, P=2):
    """A probe's recorded arrays: kept depths [C, kept], final steps and
    metrics, and per candidate depth AR(1) samples [C, kept, P] whose
    autocorrelation makes depth 3 the best ESS per leapfrog."""
    rng = np.random.default_rng(21)
    depths = rng.choice([1, 2, 3, 4], size=(C, kept), p=[0.1, 0.3, 0.4, 0.2])
    steps = rng.uniform(0.2, 0.4, size=C)
    inv_mass = rng.uniform(0.5, 2.0, size=(C, P))
    samples = {}
    for cand, rho in ((2, 0.9), (3, 0.3), (4, 0.0)):
        s = np.zeros((C, kept, P))
        noise = rng.normal(size=(C, kept, P))
        for i in range(1, kept):
            s[:, i] = rho * s[:, i - 1] + noise[:, i]
        samples[cand] = s
    return depths, steps, inv_mass, samples


@pytest.mark.parametrize("criterion", ["quantile", "ess"])
def test_choose_max_depth_decides_as_jax_on_the_same_runs(criterion, monkeypatch):
    depths, steps, inv_mass, samples = probe_tables()
    C = depths.shape[0]

    def jax_run_fn(kernel, schedule, num_iters, burnin, keys, record_thin=1):
        key = keys[0]
        table = jnp.asarray(depths if key == "depth" else samples[kernel.max_depth])

        def run(k, theta0):
            i = theta0[0].astype(jnp.int32)
            return _ProbeState(jnp.asarray(steps)[i], jnp.asarray(inv_mass)[i]), {key: table[i]}
        return run

    def port_probe_run(kernel, schedule, theta0s, num_iters, burnin, key, generator):
        table = depths if key == "depth" else samples[kernel.max_depth]
        return _ProbeState(t(steps), t(inv_mass)), t(table)

    monkeypatch.setattr(jrunner, "run_fn", jax_run_fn)
    monkeypatch.setattr(tnuts, "_probe_run", port_probe_run)
    jm, tm, x, y = gaussian(np.eye(2))
    inits = np.stack([np.arange(C), np.zeros(C)], axis=1).astype(np.float64)
    kw = dict(step=0.3, num_warmup=256, criterion=criterion, return_metric=True,
              probe_max_depth=6)
    jd, jstep, jmetric = jchoose_max_depth(jm, (jnp.asarray(x), jnp.asarray(y)),
                                           theta0s=jnp.asarray(inits), **kw)
    td, tstep, tmetric = choose_max_depth(tm, (x, y), theta0s=t(inits), **kw)
    assert td == jd == (4 if criterion == "quantile" else 3)
    np.testing.assert_allclose(tstep, jstep, **F64_TOL)
    np.testing.assert_allclose(tmetric, jmetric, **F64_TOL)


def test_unknown_criterion_raises():
    _, tm, x, y = gaussian(np.eye(2))
    with pytest.raises(ValueError, match="criterion"):
        choose_max_depth(tm, (x, y), step=0.4, num_warmup=32, theta0s=torch.zeros((4, 2)),
                         criterion="bogus")


def test_resolve_auto_budget_freezes_depth_and_step_once_per_data():
    _, tm, x, y = xor()
    kernel = NUTS(tm, step=0.1, max_depth="auto", tuner=HMCDATuner(d=0.8))
    assert kernel.auto_depth and kernel.max_depth == 10
    kernel.resolve_auto_budget((x, y), torch.Generator().manual_seed(0), num_warmup=64,
                               num_chains=4)
    assert isinstance(kernel.max_depth, int) and 1 <= kernel.max_depth <= 4
    assert kernel.step0 > 0.0 and kernel.tuner.e0 == kernel.step0
    d, s = kernel.max_depth, kernel.step0
    kernel.resolve_auto_budget((x, y), torch.Generator().manual_seed(9))
    assert (kernel.max_depth, kernel.step0) == (d, s)
    explicit = NUTS(tm, step=0.1, max_depth=3)
    explicit.resolve_auto_budget((x, y))
    assert explicit.max_depth == 3 and explicit._auto_fingerprint is None


@pytest.mark.parametrize("prior_less", [False, True])
def test_sample_chains_runs_the_probe_itself(prior_less, monkeypatch):
    """The runners call ``resolve_auto_budget`` before dispatch, with the
    caller's generator, and hand the run's inits to the probe of a
    prior-less model only; the probe's result then drives the run."""
    _, tm, x, y = gaussian(np.eye(2)) if prior_less else xor()
    calls = []

    def probe(model, schedule, **kw):
        calls.append(kw)
        return 2, 0.25, np.full(tm.num_params, 0.5)

    monkeypatch.setattr(tnuts, "choose_max_depth", probe)
    kernel = NUTS(tm, step=0.1, max_depth="auto", mass_adapt=True)
    theta0s = 0.1 * torch.randn((2, tm.num_params), generator=torch.Generator().manual_seed(2),
                                dtype=torch.float64)
    out = sample_chains(kernel, torch.Generator().manual_seed(3), theta0s, (x, y), num_iters=8,
                        return_arrays=True, backend="scan")
    assert out["sample"].shape == (2, 8, tm.num_params)
    assert len(calls) == 1 and calls[0]["criterion"] == "ess"
    assert calls[0]["probe_max_depth"] == 4 and calls[0]["mass_adapt"]
    assert (calls[0]["theta0s"] is not None) == prior_less
    assert (kernel.max_depth, kernel.step0) == (2, 0.25) and kernel._auto_fingerprint is not None
    np.testing.assert_array_equal(kernel._frozen_inv_mass, 0.5)
    assert bool((out["depth"] <= 2).all())
    sample_chains(kernel, torch.Generator().manual_seed(4), theta0s, (x, y), num_iters=4,
                  backend="scan")
    assert len(calls) == 1  # once per dataset


def test_auto_on_a_prior_less_model_needs_inits():
    _, tm, x, y = gaussian(np.eye(2))
    kernel = NUTS(tm, step=0.4, max_depth="auto")
    with pytest.raises(ValueError, match="theta0s"):
        kernel.resolve_auto_budget((x, y))
    kernel.resolve_auto_budget((x, y), torch.Generator().manual_seed(1), num_warmup=32,
                               theta0s=torch.zeros((4, 2), dtype=torch.float64))
    assert 1 <= kernel.max_depth <= 4
