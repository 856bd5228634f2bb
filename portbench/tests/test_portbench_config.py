"""What a configuration file states decides the model the program builds
and the reference posterior the check judges it by: the two configurations
of the cells build what they built before, a relu or tanh network is built
and judged from its files alone, and an unknown name raises, naming its
key."""

import copy
import functools
import json
import math
import os
import types
from pathlib import Path

import pytest
import torch

from harness import check, program, spec
from harness.spec import Cell, reference_of

CPU = torch.device("cpu")
TEST_CONFIG = json.loads((Path(__file__).parent / "configs" / "relu_mlp5163.json").read_text())
CELL_CONFIGS = {"iris_mlp433": "iris_mala", "xor_mlp221": "xor_hmc"}


def _config(name):
    return copy.deepcopy(TEST_CONFIG if name == "relu_mlp5163"
                         else Cell(CELL_CONFIGS[name]).config)


def _parent_model(config):
    """The model as the harness built it before the configuration chose its
    activations (sigmoid hidden units only)."""
    from eeyore_tpu_torch.models import MLP, IIDNormalPrior, loss_functions, mlp

    dims = config["dims"]
    out = None if config["loss"] == "multiclass_classification" else mlp.sigmoid
    hp = mlp.Hyperparameters(dims=dims, bias=config["bias"],
                             activations=[mlp.sigmoid] * (len(dims) - 2) + [out])
    P = config["num_params"]
    prior = IIDNormalPrior(torch.full((P,), float(config["prior"]["loc"])),
                           torch.full((P,), float(config["prior"]["scale"])),
                           dtype=torch.float32, device=CPU)
    return MLP(loss=loss_functions[config["loss"]], hparams=hp, prior=prior,
               dtype=torch.float32, device=CPU)


def _parent_vg(config, x, y, dtype, theta):
    """The reference's value and gradient as they were written for sigmoid
    hidden units alone, kept to hold the factory's arithmetic to the bit."""
    dims, loss = list(config["dims"]), config["loss"]
    loc, scale = float(config["prior"]["loc"]), float(config["prior"]["scale"])
    P = config["num_params"]
    x, y = x.to(dtype), y.to(dtype)
    prior_const = P * (-math.log(scale) - 0.5 * math.log(2 * math.pi))
    theta = theta.to(dtype)
    B, L = theta.shape[0], len(dims) - 1
    weights, acts, off, h = [], [x], 0, x
    for l in range(L):
        d_in, d_out = dims[l], dims[l + 1]
        w = theta[:, off:off + d_in * d_out].reshape(B, d_out, d_in)
        off += d_in * d_out
        b = theta[:, off:off + d_out]
        off += d_out
        weights.append(w)
        z = torch.matmul(h, w.transpose(1, 2)) + b[:, None, :]
        if l < L - 1:
            h = torch.sigmoid(z)
            acts.append(h)
    if loss == "multiclass_classification":
        logp = torch.log_softmax(z, dim=-1)
        log_lik = torch.sum(y * logp, dim=(1, 2))
        delta = y - torch.exp(logp)
    else:
        log_lik = torch.sum(y * z - torch.nn.functional.softplus(z), dim=(1, 2))
        delta = y - torch.sigmoid(z)
    diff = (theta - loc) / scale
    val = log_lik - 0.5 * torch.sum(diff * diff, dim=1) + prior_const
    parts = []
    for l in reversed(range(L)):
        a = acts[l]
        g_w = torch.matmul(delta.transpose(1, 2), a)
        parts.append(torch.sum(delta, dim=1))
        parts.append(g_w.reshape(B, g_w.shape[1] * g_w.shape[2]))
        if l > 0:
            delta = torch.matmul(delta, weights[l]) * a * (1.0 - a)
    return val, torch.cat(parts[::-1], dim=1) - diff / scale


def _thetas(P, n=8, seed=5, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, P), generator=gen, dtype=dtype)


@pytest.mark.parametrize("name", sorted(CELL_CONFIGS))
def test_cell_configs_build_the_parents_objects(name):
    config = _config(name)
    model, parent = program.build_model(config, CPU), _parent_model(config)
    assert model.loss is parent.loss
    assert len(model.hp.activations) == len(parent.hp.activations)
    assert all(a is b for a, b in zip(model.hp.activations, parent.hp.activations))
    assert (model.hp.dims, model.hp.bias) == (parent.hp.dims, parent.hp.bias)
    for key in ("loc", "scale"):
        a, b = getattr(model.prior, key), getattr(parent.prior, key)
        assert a.dtype == b.dtype and torch.equal(a, b)
    from eeyore_tpu_torch.ops.mlp_math import extract_arch

    assert extract_arch(model) == extract_arch(parent)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("name", sorted(CELL_CONFIGS))
def test_reference_factory_vg_is_the_parents_to_the_bit(name, dtype):
    config = _config(name)
    x, y = program.dataset(config, CPU)
    post = reference_of(config).posterior(config, x, y, dtype, CPU)
    theta = 0.5 * _thetas(config["num_params"], n=16)
    val, grad = post.vg(theta)
    want_val, want_grad = _parent_vg(config, x, y, dtype, theta)
    assert val.dtype == dtype
    assert torch.equal(val, want_val) and torch.equal(grad, want_grad)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_config_port_agrees_with_reference(activation):
    from eeyore_tpu_torch.models import MLP, IIDNormalPrior

    config = _config("relu_mlp5163")
    config["hidden_activation"] = activation
    x, y = (t.double() for t in program.dataset(config, CPU))
    built = program.build_model(config, CPU)
    assert built.hp.activations[0] is getattr(torch, activation)
    # the same model in float64: its loss, layers and prior as built
    prior = IIDNormalPrior(built.prior.loc.double(), built.prior.scale.double(),
                           dtype=torch.float64, device=CPU)
    model = MLP(loss=built.loss, hparams=built.hp, prior=prior, dtype=torch.float64, device=CPU)
    post = reference_of(config).posterior(config, x, y, torch.float64, CPU)
    theta = _thetas(config["num_params"])
    val, grad = model.upto_grad_log_target(theta, x, y)
    want_val, want_grad = post.vg(theta)
    assert torch.all(torch.abs(val - want_val) <= 1e-10 * torch.abs(want_val))
    scale = torch.amax(torch.abs(want_grad), dim=1, keepdim=True)
    assert torch.all(torch.abs(grad - want_grad) <= 1e-10 * scale)
    # the written-out gradient is the gradient of the written-out value
    auto = torch.func.vmap(torch.func.grad(lambda t: post.log_posterior(t[None])[0]))(theta)
    assert torch.allclose(auto, want_grad, rtol=1e-10, atol=1e-10 * float(scale.max()))


def test_loss_args_reach_the_loss(monkeypatch):
    from eeyore_tpu_torch.models import loss_functions

    def scaled_cross_entropy(logits, y, scale):
        return scale * loss_functions["multiclass_classification"](logits, y)

    monkeypatch.setitem(loss_functions, "scaled_test", scaled_cross_entropy)
    config = {**_config("relu_mlp5163"), "loss": "scaled_test", "loss_args": {"scale": 2.0}}
    model = program.build_model(config, CPU)
    assert isinstance(model.loss, functools.partial)
    assert model.loss.func is scaled_cross_entropy and model.loss.keywords == {"scale": 2.0}


@pytest.mark.parametrize("key,value,where", [
    ("hidden_activation", "gelu", "build"), ("output_activation", "softplus", "build"),
    ("output_activation", "relu", "build"), ("loss", "poisson", "build"),
    ("model", "cnn", "build"), ("dtype", "float16", "build"), ("dtype", "float64", "build"),
    ("hidden_activation", "gelu", "reference"), ("loss", "poisson", "reference"),
    ("output_activation", "sigmoid", "reference"), ("reference", "reference/nope.py", "judge"),
])
def test_unknown_names_raise_naming_the_key(key, value, where):
    config = _config("relu_mlp5163")
    config[key] = value
    with pytest.raises(ValueError, match=key):
        if where == "build":
            program.build_model(config, CPU)
        elif where == "judge":
            reference_of(config)
        else:
            x, y = program.dataset(config, CPU)
            reference_of(_config("relu_mlp5163")).posterior(config, x, y, torch.float64, CPU)


def _named_reference(directory):
    path = directory / "named_reference.py"
    path.write_text("def posterior(config, x, y, dtype, device):\n"
                    "    return ('named', config['name'], dtype)\n")
    return path


@pytest.mark.parametrize("relative", [False, True], ids=["absolute", "dotdot"])
def test_reference_outside_portbench_is_refused(tmp_path, relative):
    path = _named_reference(tmp_path)
    config = _config("relu_mlp5163")
    config["reference"] = os.path.relpath(path, spec.BENCH_DIR) if relative else str(path)
    with pytest.raises(ValueError, match="reference"):
        reference_of(config)


def test_check_takes_the_posterior_the_configuration_names(tmp_path, monkeypatch):
    cell = Cell("iris_mala")
    _named_reference(tmp_path)
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    monkeypatch.setitem(cell.config, "reference", "named_reference.py")
    judge = check.Judge(cell, cell.traffic, cell.spec["check"], CPU)
    inputs = types.SimpleNamespace(x=None, y=None)
    assert judge.posterior(inputs, torch.bfloat16) == ("named", "iris_mlp433", torch.bfloat16)
