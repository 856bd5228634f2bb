"""Port, the makers' signatures: every ``make_*`` function of the port's
``ops`` has its JAX twin's default for each parameter both share (the port
adds ``device``; the fused body has no TPU tiling knobs), so a call written
for the JAX package means the same on the port (``make_resident_hmc``'s
tuning group of 2048 chains, for one)."""

import importlib
import inspect

import pytest

MAKERS = [
    ("fused_mlp", "make_fused_log_target_vg"),
    ("mlp_math", "make_vg"),
    ("mlp_math", "make_incremental_gibbs"),
    ("mlp_dense", "make_vg_dense"),
    ("mlp_dense", "make_incremental_gibbs_dense"),
    ("resident_hmc", "make_resident_hmc"),
    ("resident_hmc_dense", "make_resident_hmc_dense"),
    ("resident_walk", "make_resident_mh"),
    ("resident_walk", "make_resident_mala"),
    ("resident_walk", "make_resident_gibbs"),
    ("resident_walk_dense", "make_resident_mh_dense"),
    ("resident_walk_dense", "make_resident_mala_dense"),
    ("resident_walk_dense", "make_resident_gibbs_dense"),
    ("resident_tempering", "make_resident_tempering"),
    ("resident_tempering_dense", "make_resident_tempering_dense"),
    ("resident_nuts", "make_resident_nuts"),
    ("resident_nuts_dense", "make_resident_nuts_dense"),
    ("resident_smc", "make_generic_vg"),
    ("resident_smc", "make_resident_smc_mutation"),
    ("resident_smc", "make_resident_smc"),
]
# parameters of one side only, by design
PORT_ONLY = {"device"}
JAX_ONLY = {"make_fused_log_target_vg": {"chain_block", "interpret"}}


def parameters(package, module, name):
    fn = getattr(importlib.import_module(f"{package}.ops.{module}"), name)
    return inspect.signature(fn).parameters


def test_every_maker_of_the_port_is_listed():
    """A maker added to the port's ``ops`` joins the list above."""
    listed = {name for _, name in MAKERS}
    for module in {m for m, _ in MAKERS}:
        ops = importlib.import_module(f"eeyore_tpu_torch.ops.{module}")
        found = {n for n, f in vars(ops).items() if n.startswith("make_")
                 and inspect.isfunction(f) and f.__module__ == ops.__name__}
        assert found <= listed, module


@pytest.mark.parametrize("module,name", MAKERS)
def test_maker_defaults_equal_jaxs(module, name):
    port = parameters("eeyore_tpu_torch", module, name)
    jax = parameters("eeyore_tpu", module, name)
    assert set(port) - set(jax) <= PORT_ONLY
    assert set(jax) - set(port) == JAX_ONLY.get(name, set())
    shared = [p for p in jax if p in port]
    assert shared == [p for p in port if p in jax], name  # the same order
    for p in set(port) & set(jax):
        assert port[p].default == jax[p].default, (name, p)
        assert port[p].kind == jax[p].kind, (name, p)
