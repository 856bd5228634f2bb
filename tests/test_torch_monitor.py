"""Port, run monitoring: ``samplers/monitor.py::summarize_run`` against the
JAX package's. On identical arrays (and final states) the two give equal
dictionaries: acceptance per iteration [C, T], the blocked Gibbs branch
[C, T, B], NUTS's ``accept_stat``, target values with diverged chains, a
tuned state's step and trajectory length, from a dict of arrays and from a
``ChainLists`` in each package. The port's own runs, as
tests/test_samplers.py:121-166 runs JAX's: tuned HMC on the bivariate
normal (no stuck or diverged chain, a positive tuned step) and NUTS's
``accept_stat``; each summary equals JAX's summary of the same arrays."""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.chains import ChainLists as JChainLists
from eeyore_tpu.samplers import summarize_run as jsummarize_run
from eeyore_tpu_torch.chains import ChainLists
from eeyore_tpu_torch.models import DistributionModel
from eeyore_tpu_torch.samplers import HMC, NUTS, sample_chains, summarize_run
from eeyore_tpu_torch.tuners.dual_averaging import HMCDATuner


class TunedState(NamedTuple):
    sample: object
    step: object
    num_steps: object


def arrays(kind, seed=0, C=16, T=40, P=3, B=4):
    rng = np.random.default_rng(seed)
    out = {"sample": rng.normal(size=(C, T, P)),
           "target_val": rng.normal(size=(C, T)).astype(np.float32)}
    if kind == "gibbs":
        out["accepted"] = (rng.random((C, T, B)) < 0.4).astype(np.int32)
    else:
        out["accepted"] = (rng.random((C, T)) < rng.random((C, 1))).astype(np.int32)
        out["accepted"][0] = 0  # a stuck chain
        out["target_val"][1, -1] = -np.inf  # a diverged chain
    if kind == "nuts":
        out["accept_stat"] = rng.random((C, T))
    return out


def as_jax(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def as_torch(a):
    return {k: torch.as_tensor(v) for k, v in a.items()}


@pytest.mark.parametrize("kind", ["walk", "gibbs", "nuts"])
@pytest.mark.parametrize("container", ["dict", "chainlists"])
def test_summaries_equal_jax(kind, container):
    a = arrays(kind)
    rng = np.random.default_rng(1)
    step = rng.random(16) * 0.1
    num_steps = rng.integers(1, 20, size=16).astype(np.int32)
    state = TunedState(sample=None, step=torch.as_tensor(step),
                       num_steps=torch.as_tensor(num_steps))
    jstate = TunedState(sample=None, step=jnp.asarray(step), num_steps=jnp.asarray(num_steps))
    if container == "dict":
        got, want = summarize_run(as_torch(a), state), jsummarize_run(as_jax(a), jstate)
    else:
        got = summarize_run(ChainLists.from_arrays(as_torch(a)), state)
        want = jsummarize_run(JChainLists.from_arrays(as_jax(a)), jstate)
    assert got == want
    if kind == "gibbs":
        assert len(got["block_acceptance_mean"]) == 4
    else:
        assert got["num_stuck_chains"] >= 1 and got["num_diverged_chains"] == 1
    assert ("accept_stat_mean" in got) == (kind == "nuts")


def test_without_state_or_keys():
    a = arrays("walk")
    got = summarize_run({"sample": torch.as_tensor(a["sample"])})
    assert got == jsummarize_run({"sample": jnp.asarray(a["sample"])}) == {}


COV = np.array([[1.0, 0.5], [0.5, 1.0]])


def bvn_model():
    prec = torch.as_tensor(np.linalg.inv(COV))
    return DistributionModel(lambda t, x, y: -0.5 * ((t @ prec) * t).sum(-1), num_params=2,
                             dtype=torch.float64, device="cpu")


EMPTY = (torch.zeros((1, 0), dtype=torch.float64), torch.zeros((1, 0), dtype=torch.float64))


def test_summarize_tuned_hmc_run():
    kern = HMC(bvn_model(), tuner=HMCDATuner(l=1.0, e0=0.2))
    g = torch.Generator().manual_seed(0)
    theta0s = torch.randn(8, 2, generator=g, dtype=torch.float64)
    recorded, state = sample_chains(kern, g, theta0s, EMPTY, 600, 300, return_arrays=True,
                                    return_state=True)
    summary = summarize_run(recorded, state)
    assert 0.2 < summary["acceptance_mean"] <= 1.0
    assert summary["num_stuck_chains"] == 0
    assert summary["num_diverged_chains"] == 0
    assert summary["tuned_step"]["mean"] > 0
    assert summary["tuned_num_steps"]["max"] >= 1
    host = {k: jnp.asarray(v.numpy()) for k, v in recorded.items()}
    jstate = TunedState(sample=None, step=jnp.asarray(state.step.numpy()),
                        num_steps=jnp.asarray(state.num_steps.numpy()))
    assert summary == jsummarize_run(host, jstate)


def test_summarize_run_accept_stat():
    kern = NUTS(bvn_model(), step=0.5, max_depth=5)
    g = torch.Generator().manual_seed(3)
    theta0s = torch.randn(4, 2, generator=g, dtype=torch.float64)
    recorded = sample_chains(kern, g, theta0s, EMPTY, 100, 0, return_arrays=True,
                             record_keys=("sample", "accepted", "accept_stat"))
    summary = summarize_run(recorded)
    assert 0.0 < summary["accept_stat_mean"] <= 1.0
    assert summary == jsummarize_run({k: jnp.asarray(v.numpy()) for k, v in recorded.items()})
