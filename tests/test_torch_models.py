"""Port parity, models and data: the PyTorch port's MLP, losses, prior and
datasets against the JAX package, in float64 on the CPU. Inputs come from a
numpy seed and reach both packages as numpy arrays."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeyore_tpu.datasets import XYDataset as JXYDataset
from eeyore_tpu.models import IIDNormalPrior as JIIDNormalPrior
from eeyore_tpu.models import MLP as JMLP
from eeyore_tpu.models import losses as jlosses
from eeyore_tpu.models import mlp as jmlp
from eeyore_tpu_torch import convert
from eeyore_tpu_torch.datasets import XYDataset, one_hot
from eeyore_tpu_torch.models import IIDNormalPrior, MLP, loss_functions, losses, mlp

REPO = Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(2024)
F64_TOL = dict(rtol=1e-10, atol=1e-10)


def make_pair(dims, loss, bias=None, prior_loc=None, prior_scale=None, temperature=None):
    """The same MLP in both packages, in float64 on the CPU."""
    ce = loss == "multiclass_classification"
    jacts = [jmlp.sigmoid] * (len(dims) - 2) + [None if ce else jmlp.sigmoid]
    tacts = [mlp.sigmoid] * (len(dims) - 2) + [None if ce else mlp.sigmoid]
    jm = JMLP(loss=jlosses.loss_functions[loss],
              hparams=jmlp.Hyperparameters(dims=dims, bias=bias, activations=jacts),
              dtype=jnp.float64)
    tm = MLP(loss=loss_functions[loss],
             hparams=mlp.Hyperparameters(dims=dims, bias=bias, activations=tacts),
             dtype=torch.float64, device="cpu")
    if prior_loc is not None:
        jm.prior = JIIDNormalPrior(prior_loc, prior_scale)
        tm.prior = convert.prior_from_numpy(prior_loc, prior_scale, device="cpu")
    jm.temperature = temperature
    tm.temperature = convert.temperature_from_numpy(temperature)
    return jm, tm


def xor_data():
    return JXYDataset.from_eeyore("xor").x, JXYDataset.from_eeyore("xor").y


def iris_data():
    ds = JXYDataset.from_eeyore("iris", yonehot=True)
    return ds.x, ds.y


def deep_data():
    rng = np.random.default_rng(5)
    return rng.normal(size=(10, 3)), rng.integers(0, 2, size=(10, 1)).astype(np.float64)


CASES = {
    "xor": (lambda: make_pair([2, 2, 1], "binary_classification"), xor_data),
    "iris": (lambda: make_pair([4, 3, 3], "multiclass_classification",
                               prior_loc=np.full(27, 0.5), prior_scale=np.full(27, 2.0),
                               temperature=0.3), iris_data),
    "deep_no_bias": (lambda: make_pair([3, 4, 2, 1], "binary_classification",
                                       bias=[False, True, False],
                                       prior_loc=np.linspace(-1, 1, 24),
                                       prior_scale=np.linspace(0.5, 3, 24),
                                       temperature=0.7), deep_data),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_target_and_grad_match_jax(case):
    make, data = CASES[case]
    jm, tm = make()
    x, y = data()
    thetas = RNG.normal(size=(6, tm.num_params))
    for theta in thetas:
        jv, jg = jax.value_and_grad(jm.log_target)(jnp.asarray(theta), jnp.asarray(x),
                                                   jnp.asarray(y))
        tv, tg = tm.upto_grad_log_target(torch.as_tensor(theta), torch.as_tensor(x),
                                         torch.as_tensor(y))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F64_TOL)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **F64_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_log_target_matches_jax_vmap(case):
    """A leading batch of thetas gives each chain its own value and gradient."""
    make, data = CASES[case]
    jm, tm = make()
    x, y = data()
    thetas = RNG.normal(size=(5, tm.num_params))
    jv, jg = jax.vmap(lambda t: jax.value_and_grad(jm.log_target)(
        t, jnp.asarray(x), jnp.asarray(y)))(jnp.asarray(thetas))
    tv, tg = tm.upto_grad_log_target(torch.as_tensor(thetas), torch.as_tensor(x),
                                     torch.as_tensor(y))
    assert tv.shape == (5,) and tg.shape == (5, tm.num_params)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F64_TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **F64_TOL)


def test_temperature_multiplies_lik_and_prior():
    jm, tm = make_pair([2, 2, 1], "binary_classification", temperature=0.25)
    x, y = xor_data()
    theta = torch.as_tensor(RNG.normal(size=tm.num_params))
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    cold = tm.with_temperature(None)
    expected = 0.25 * (cold.log_lik(theta, xt, yt) + cold.log_prior(theta))
    torch.testing.assert_close(tm.log_target(theta, xt, yt), expected, rtol=1e-12, atol=1e-12)


def test_unpack_pack_roundtrip_and_layout():
    jm, tm = make_pair([3, 4, 2, 1], "binary_classification", bias=[False, True, False])
    theta = RNG.normal(size=tm.num_params)
    layers = tm.unpack(torch.as_tensor(theta))
    jlayers = jm.unpack(jnp.asarray(theta))
    for (w, b), (jw, jb) in zip(layers, jlayers):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        assert (b is None) == (jb is None)
        if b is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.pack(layers).numpy(), theta)


def test_forward_matches_jax():
    jm, tm = make_pair([4, 3, 3], "multiclass_classification")
    x, _ = iris_data()
    theta = RNG.normal(size=tm.num_params)
    np.testing.assert_allclose(tm.forward(torch.as_tensor(theta), torch.as_tensor(x)).numpy(),
                               np.asarray(jm.forward(jnp.asarray(theta), jnp.asarray(x))),
                               **F64_TOL)


def test_hyperparameters_validate():
    with pytest.raises(ValueError):
        mlp.Hyperparameters(dims=[2, 1])
    with pytest.raises(ValueError):
        mlp.Hyperparameters(dims=[2, 2, 1], bias=[True])
    with pytest.raises(ValueError):
        mlp.Hyperparameters(dims=[2, 2, 1], activations=[mlp.sigmoid])


def test_bce_saturated_probabilities_no_nan():
    """0*log(0) = 0: a saturated, correctly classified point gives a zero loss
    and a finite gradient; a point saturated on the wrong side gives +inf,
    as in the JAX package."""
    y = torch.tensor([1.0, 0.0], dtype=torch.float64)
    x_correct = torch.tensor([1.0, 0.0], dtype=torch.float64, requires_grad=True)
    loss = losses.binary_cross_entropy(x_correct, y, reduction="sum")
    (grad,) = torch.autograd.grad(loss, x_correct)
    assert loss.detach().item() == 0.0
    assert torch.isfinite(grad).all()
    jgrad = jax.grad(lambda v: jlosses.binary_cross_entropy(v, jnp.asarray([1.0, 0.0]), "sum"))(
        jnp.asarray([1.0, 0.0]))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(jgrad))
    x_wrong = torch.tensor([0.0, 1.0], dtype=torch.float64)
    assert torch.isinf(losses.binary_cross_entropy(x_wrong, y, reduction="sum"))
    x_f32 = torch.sigmoid(torch.tensor([30.0, -30.0]))  # saturates to exactly 1.0 and ~0
    assert torch.isfinite(losses.binary_cross_entropy(x_f32, y.float(), reduction="sum"))


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_losses_match_jax(reduction):
    p = RNG.uniform(0.05, 0.95, size=(7, 1))
    yb = RNG.integers(0, 2, size=(7, 1)).astype(np.float64)
    np.testing.assert_allclose(
        losses.binary_cross_entropy(torch.as_tensor(p), torch.as_tensor(yb), reduction).numpy(),
        np.asarray(jlosses.binary_cross_entropy(jnp.asarray(p), jnp.asarray(yb), reduction)),
        **F64_TOL)
    logits = RNG.normal(size=(9, 3)) * 5
    yc = np.eye(3)[RNG.integers(0, 3, 9)]
    np.testing.assert_allclose(
        losses.cross_entropy(torch.as_tensor(logits), torch.as_tensor(yc), reduction).numpy(),
        np.asarray(jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(yc), reduction)),
        **F64_TOL)
    with pytest.raises(ValueError):
        losses.cross_entropy(torch.as_tensor(logits), torch.as_tensor(yc), "none")


def test_prior_matches_jax():
    loc, scale = RNG.normal(size=5), RNG.uniform(0.5, 2.0, size=5)
    theta = RNG.normal(size=5)
    tp = IIDNormalPrior(loc, scale, device="cpu")
    jp = JIIDNormalPrior(loc, scale)
    np.testing.assert_allclose(tp.log_prob(torch.as_tensor(theta)).numpy(),
                               np.asarray(jp.log_prob(jnp.asarray(theta))), **F64_TOL)
    std = IIDNormalPrior.standard(4, dtype=torch.float64, device="cpu")
    iso = IIDNormalPrior.isotropic(4, 3.0, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(std.scale.numpy(), np.ones(4))
    np.testing.assert_array_equal(iso.scale.numpy(), np.full(4, 3.0))
    assert iso.loc.dtype == torch.float64 and iso.device.type == "cpu"
    g = torch.Generator().manual_seed(0)
    assert tp.sample(g).shape == (5,)


def test_model_matmuls_pinned_off_tf32(monkeypatch):
    """The model runs its matmuls at full float32 ("highest": no TF32)
    whatever the process-wide setting, and restores that setting after."""
    jm, tm = make_pair([2, 2, 1], "binary_classification")
    seen = []
    real_matmul = torch.matmul

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision())
        return real_matmul(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        tm.forward(torch.zeros(tm.num_params, dtype=torch.float64), torch.ones(3, 2,
                                                                          dtype=torch.float64))
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(previous)
    assert tm.matmul_precision == "highest"
    assert seen == ["highest", "highest"]


def test_default_device_is_cuda():
    m = MLP(loss=loss_functions["binary_classification"],
            hparams=mlp.Hyperparameters(dims=[2, 2, 1]), prior=IIDNormalPrior(
                np.zeros(9), np.ones(9), device="cpu"))
    assert m.device.type == "cuda"


@pytest.mark.parametrize("name,yonehot", [("xor", False), ("iris", True)])
def test_datasets_match_jax(name, yonehot):
    ds = XYDataset.from_eeyore(name, yonehot=yonehot)
    jds = JXYDataset.from_eeyore(name, yonehot=yonehot)
    np.testing.assert_array_equal(ds.x, jds.x)
    np.testing.assert_array_equal(ds.y, jds.y)
    assert len(ds) == len(jds)
    with pytest.raises(ValueError):
        XYDataset.from_eeyore("nope")
    np.testing.assert_array_equal(one_hot([2, 0, 1]), np.eye(3)[[2, 0, 1]])


def test_port_imports_no_jax():
    """The port, its examples and its chip check import neither JAX nor the
    JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|eeyore_tpu)(\.|\s|$)", re.MULTILINE)
    examples = sorted((REPO / "examples_torch").rglob("*.py"))
    files = sorted((REPO / "eeyore_tpu_torch").rglob("*.py")) + examples + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and len(examples) == 13
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
