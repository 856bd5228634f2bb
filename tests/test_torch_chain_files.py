"""Port, chain files and checkpoints (``chains/chain_file.py``,
``chains/checkpoint.py``) and the rest of the ``ChainList`` and
``ChainLists`` methods, against the JAX package's on the same float64
arrays: every ported method's result; the CSVs written by both packages
equal byte for byte and each package reading the other's; ``.npz`` columns
and sampler checkpoints (an untuned and a tuned ``HMCState``, an
``NUTSState``) written by either package loading into the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.chains import ChainFile as JChainFile
from eeyore_tpu.chains import ChainList as JChainList
from eeyore_tpu.chains import ChainLists as JChainLists
from eeyore_tpu.chains import load_state as jload_state
from eeyore_tpu.chains import save_state as jsave_state
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import loss_functions as jloss_functions
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu.samplers import HMC as JHMC
from eeyore_tpu.samplers import NUTS as JNUTS
from eeyore_tpu.tuners.dual_averaging import HMCDATuner as JHMCDATuner
from eeyore_tpu_torch.chains import ChainFile, ChainList, ChainLists, load_state, save_state
from eeyore_tpu_torch.chains.chain_file import DEFAULT_FMT
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.samplers import HMC, NUTS
from eeyore_tpu_torch.samplers.hmc import HMCState
from eeyore_tpu_torch.samplers.nuts import NUTSState
from eeyore_tpu_torch.tuners import HMCDATuner

RNG = np.random.default_rng(18)
XOR = (np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]]), np.array([[0.], [1.], [1.], [0.]]))
N, P = 1000, 3


def arrays(seed=0, grad=True):
    """One chain's columns as float64 numpy: an AR(1) sample, its target,
    gradient and accept flags."""
    rng = np.random.default_rng(seed)
    sample = np.zeros((N, P))
    for i in range(1, N):
        sample[i] = 0.6 * sample[i - 1] + rng.normal(size=P)
    out = {"sample": sample, "target_val": -0.5 * (sample ** 2).sum(1),
           "accepted": (rng.random(N) < 0.7).astype(np.int64)}
    if grad:
        out["grad_val"] = -sample
    return out


def pair(seed=0, grad=True):
    a = arrays(seed, grad)
    return (ChainList.from_arrays({k: torch.as_tensor(v) for k, v in a.items()}),
            JChainList.from_arrays(a))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=1e-10, atol=1e-12)


# ---- ChainList ----

def test_chain_list_accessors_equal_jax():
    chain, jchain = pair()
    for k in chain.keys():
        assert len(chain.vals[k]) == len(jchain.vals[k]) == N
        close(torch.stack(chain.vals[k]).numpy(), np.stack(jchain.vals[k]))
    close(chain.get_sample(7).numpy(), jchain.get_sample(7))
    close(chain.get_param(2).numpy(), jchain.get_param(2))
    close(chain.get_grad_vals().numpy(), jchain.get_grad_vals())
    close(chain.get_grad_val(-1).numpy(), jchain.get_grad_val(-1))
    for idx in (-1, 0, 123):
        got, want = chain.state(idx), jchain.state(idx)
        assert set(got) == set(want)
        for k in got:
            close(got[k].numpy(), want[k])
    rows = ChainList(keys=("sample", "accepted"))
    rows.update({"sample": torch.zeros(2), "accepted": torch.tensor(1)})
    assert rows.state(5) == {}  # a warning, as JAX's


def test_chain_list_statistics_equal_jax():
    chain, jchain = pair()
    close(chain.running_mean(1).numpy(), jchain.running_mean(1))
    close(chain.running_means().numpy(), jchain.running_means())
    close(chain.mc_cor().numpy(), jchain.mc_cor())
    cov = chain.mc_cov()
    close(chain.mc_cor(mc_cov_mat=cov).numpy(), jchain.mc_cor(mc_cov_mat=cov.numpy()))


def test_chain_list_npz_loads_into_either_package(tmp_path):
    chain, jchain = pair()
    chain.save(tmp_path / "port.npz")
    jchain.save(tmp_path / "jax.npz")
    back, jback = ChainList(), JChainList()
    back.load(tmp_path / "jax")
    jback.load(tmp_path / "port.npz")
    for k in chain.keys():
        close(back.column(k).numpy(), jchain.column(k))
        close(jback.column(k), chain.column(k).numpy())
    assert back.column("accepted").dtype == torch.int64


@pytest.mark.parametrize("mode", ["w", "a"])
def test_chain_files_equal_jax_byte_for_byte(tmp_path, mode):
    """The same f64 arrays through ``to_chainfile``: every CSV equal byte for
    byte (twice in append mode), and each package's ``to_chainlist`` of the
    other's files equal to the arrays."""
    chain, jchain = pair()
    keys = ("sample", "target_val", "grad_val", "accepted")
    for _ in range(2 if mode == "a" else 1):
        chain.to_chainfile(keys=keys, path=tmp_path / "port", mode=mode)
        jchain.to_chainfile(keys=keys, path=tmp_path / "jax", mode=mode)
    for k in keys:
        got = (tmp_path / "port" / f"{k}.csv").read_bytes()
        assert got == (tmp_path / "jax" / f"{k}.csv").read_bytes(), k
        assert got.count(b"\n") == N * (2 if mode == "a" else 1)
    assert (tmp_path / "port" / "accepted.csv").read_text().split("\n")[0] in ("0", "1")
    back = ChainFile(keys=keys, path=tmp_path / "jax").to_chainlist()
    jback = JChainFile(keys=keys, path=tmp_path / "port").to_chainlist()
    for k in keys:
        want = chain.column(k).numpy()
        if mode == "a":
            want = np.concatenate([want, want])
        close(back.column(k).numpy(), want)
        close(np.asarray(jback.column(k)), want)
    assert back.column("accepted").dtype == torch.int64


def test_chain_file_rows_and_f32_round_trip(tmp_path):
    """``update`` appends one row a key as JAX's does; f32 samples come back
    exactly in f32."""
    state = {"sample": torch.tensor([0.1, -2.5, 3.0], dtype=torch.float32),
             "target_val": torch.tensor(-1.25), "accepted": torch.tensor(1)}
    for path, cls in ((tmp_path / "p", ChainFile), (tmp_path / "j", JChainFile)):
        f = cls(path=path, mode="w")
        f.update({k: (v.numpy() if cls is JChainFile else v) for k, v in state.items()})
        f.update({k: (v.numpy() if cls is JChainFile else v) for k, v in state.items()},
                 reset=True)
    for k in state:
        assert (tmp_path / "p" / f"{k}.csv").read_bytes() == (tmp_path / "j" / f"{k}.csv") \
            .read_bytes()
    sample = torch.as_tensor(RNG.normal(size=(50, 4)), dtype=torch.float32)
    chain = ChainList.from_arrays({"sample": sample,
                                   "target_val": sample.sum(1),
                                   "accepted": torch.ones(50, dtype=torch.int32)})
    chain.to_chainfile(path=tmp_path / "f32", mode="w")
    back = ChainLists.from_file([tmp_path / "f32"])
    assert torch.equal(back.tensor("sample")[0].to(torch.float32), sample)
    assert torch.equal(back.tensor("accepted")[0], torch.ones(50, dtype=torch.int64))
    assert DEFAULT_FMT["accepted"] == "%d" and DEFAULT_FMT["sample"] == "%.18e"


def test_to_kanga_raises_as_jax_without_kanga():
    chain, jchain = pair()
    with pytest.raises(ImportError) as raised:
        chain.to_kanga()
    with pytest.raises(ImportError) as jraised:
        jchain.to_kanga()
    assert str(raised.value) == str(jraised.value)


# ---- ChainLists ----

def lists_pair():
    chains = [pair(seed) for seed in range(3)]
    return (ChainLists.from_chain_list([c for c, _ in chains],
                                       keys=("sample", "target_val", "grad_val", "accepted")),
            JChainLists.from_chain_list([j for _, j in chains],
                                        keys=("sample", "target_val", "grad_val", "accepted")))


def test_chain_lists_methods_equal_jax():
    lists, jlists = lists_pair()
    assert set(lists.keys()) == set(jlists.keys()) == {"sample", "target_val", "grad_val",
                                                       "accepted"}
    for k in lists.keys():
        close(np.array([[r.numpy() for r in c] for c in lists.vals[k]]),
              np.array([[np.asarray(r) for r in c] for c in jlists.vals[k]]))
    close(lists.get_grad_vals().numpy(), jlists.get_grad_vals())
    close(lists.mc_cov_summary().numpy(), jlists.mc_cov_summary())
    close(lists.mc_cor().numpy(), jlists.mc_cor())
    close(lists.mc_cor_summary().numpy(), jlists.mc_cor_summary())
    cov = lists.mc_cov()
    close(lists.mc_cor(mc_cov_mat=cov).numpy(), jlists.mc_cor(mc_cov_mat=cov.numpy()))
    close(lists.mc_cor_summary(mc_cov_mat=cov).numpy(),
          jlists.mc_cor_summary(mc_cov_mat=cov.numpy()))
    # a key some chain lacks is left out, as in JAX's
    short = ChainLists.from_chain_list([pair(0)[0], pair(1, grad=False)[0]],
                                       keys=("sample", "grad_val", "accepted"))
    assert short.keys() == ("sample", "accepted") and short.num_chains() == 2


def test_chain_lists_from_file_equal_jax(tmp_path):
    lists, _ = lists_pair()
    paths = []
    for c in range(3):
        chain = ChainList.from_arrays({k: lists.tensor(k)[c] for k in lists.keys()})
        chain.to_chainfile(path=tmp_path / f"chain{c}", mode="w")
        paths.append(tmp_path / f"chain{c}")
    keys = ("sample", "target_val", "accepted")
    got = ChainLists.from_file(paths, keys=keys)
    want = JChainLists.from_file(paths, keys=keys)
    for k in keys:
        close(got.tensor(k).numpy(), want.tensor(k))
        close(got.tensor(k).numpy(), lists.tensor(k).numpy())
    close(got.multi_rhat()[0], want.multi_rhat()[0])


# ---- checkpoints across the packages ----

def xor_models():
    return (MLP(loss_functions["binary_classification"], device="cpu", dtype=torch.float64,
                hparams=mlp.Hyperparameters(dims=[2, 2, 1])),
            JMLP(jloss_functions["binary_classification"],
                 hparams=jmlp.Hyperparameters(dims=[2, 2, 1])))


def states(kind):
    """(port state, JAX state) of 4 chains at the same thetas."""
    model, jmodel = xor_models()
    thetas = RNG.normal(size=(4, model.num_params))
    if kind == "hmc":
        kernel, jkernel = HMC(model, step=0.1, num_steps=5), JHMC(jmodel, step=0.1, num_steps=5)
    elif kind == "hmc_tuned":
        kernel = HMC(model, tuner=HMCDATuner(l=0.5, e0=0.05))
        jkernel = JHMC(jmodel, tuner=JHMCDATuner(l=0.5, e0=0.05))
    else:
        kernel = NUTS(model, step=0.1, max_depth=3)
        jkernel = JNUTS(jmodel, step=0.1, max_depth=3)
    state = kernel.init(torch.as_tensor(thetas), torch.as_tensor(XOR[0]), torch.as_tensor(XOR[1]))
    jstate = jax.vmap(lambda th: jkernel.init(th, jnp.asarray(XOR[0]), jnp.asarray(XOR[1])))(
        jnp.asarray(thetas))
    return state, jstate


@pytest.mark.parametrize("kind", ["hmc", "hmc_tuned", "nuts"])
def test_checkpoints_load_across_the_packages(tmp_path, kind):
    """Same fields, same leaves in the same order; a checkpoint of either
    package loads into the other's example state, every leaf equal and of
    the example's dtype."""
    state, jstate = states(kind)
    assert type(state)._fields == type(jstate)._fields
    assert type(state) in (HMCState, NUTSState)
    leaves = jax.tree_util.tree_leaves(jstate)
    save_state(tmp_path / "port", state)
    jsave_state(tmp_path / "jax.npz", jstate)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files and len(a.files) == len(leaves)
        for f in a.files:
            close(a[f], b[f])
    from_jax = load_state(tmp_path / "jax", state)
    from_port = jload_state(tmp_path / "port.npz", jstate)
    assert type(from_jax) is type(state)
    for got, want, like in zip(jax.tree_util.tree_leaves(from_jax),
                               jax.tree_util.tree_leaves(jstate),
                               jax.tree_util.tree_leaves(state)):
        assert isinstance(got, torch.Tensor) and got.dtype == like.dtype
        close(got.numpy(), want)
    for got, want in zip(jax.tree_util.tree_leaves(from_port), jax.tree_util.tree_leaves(state)):
        close(got, want.numpy())


def test_load_state_puts_leaves_on_the_example_and_checks_the_count(tmp_path):
    state, _ = states("hmc")
    like = state._replace(sample=state.sample.to(torch.float32), tuner=None)
    save_state(tmp_path / "s.npz", state._replace(tuner=None))
    back = load_state(tmp_path / "s.npz", like)
    assert back.tuner is None and back.sample.dtype == torch.float32
    assert torch.equal(back.accepted, state.accepted)
    with pytest.raises(ValueError, match="leaves"):
        load_state(tmp_path / "s.npz", state)
