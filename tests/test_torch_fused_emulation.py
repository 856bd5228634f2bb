"""Port, the fused log-posterior kernel ``csrc/fused_mlp_vg.cu`` (a chain on 1,
2, 4 or 8 lanes of a warp) and the SMC closure pass
``csrc/resident_smc_closure.cu`` (one thread a particle) compiled for the
host with g++ against ``tests/cuda_host_emulation.h`` (the build fixture of
``test_torch_lane_emulation.py``), their launch entry points called through
ctypes on CPU tensors and held per chain against the plain versions: the
fused kernel against ``mlp_math.make_vg`` in the ``[C, P]`` layout of its
caller, on a ragged chain count, and once against JAX's Pallas kernel in
interpret mode; the closure pass against ``_run_mutation_plain`` on
``make_generic_vg`` (``fn.plain``). The card's own compiler and its timings
are ``chip_smoke.py``'s."""

import ctypes
import math

import numpy as np
import pytest
import torch
from test_torch_lane_emulation import build, max_err, problem  # noqa: F401

from eeyore_tpu_torch.models import MLP, DistributionModel, IIDNormalPrior, loss_functions, mlp
from eeyore_tpu_torch.ops import fused_mlp, resident_smc
from eeyore_tpu_torch.ops.mlp_math import make_vg, prepare_data

EMPTY = (np.zeros((1, 0)), np.zeros((1, 0)))


def fused_problem(name):
    """(model, x, y, atol): a 30-row iris subset MLP(4,3,3), XOR MLP(2,2,1),
    or chip_smoke.py's mlp3421_nobias_prior_temp case (MLP(3,4,2,1) without
    biases on layers 0 and 2, a (0.5, 2.0) prior, temperature 0.3, 10
    rows)."""
    if name == "deep":
        model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                    device="cpu",
                    hparams=mlp.Hyperparameters(dims=[3, 4, 2, 1], bias=[False, True, False]))
        P = model.num_params
        model.prior = IIDNormalPrior(np.full(P, 0.5), np.full(P, 2.0), dtype=torch.float32,
                                     device="cpu")
        model.temperature = 0.3
        rng = np.random.default_rng(0)
        return model, rng.normal(size=(10, 3)), rng.integers(0, 2, (10, 1)).astype(float), 1e-4
    model, (x, y) = problem(name)
    return model, x, y, 1e-4


def launch_fused(lib, model, x, y, thetas, threads):
    """The build's launch entry point on thetas [C, P]: (vals [C], grads [C, P])."""
    arrays = prepare_data(model, x, y)
    tensors = [torch.as_tensor(a).contiguous() for a in arrays[:5]]
    C, P = thetas.shape
    vals, grads = torch.zeros(C), torch.zeros((C, P))
    err = lib.fused_mlp_vg_launch(
        thetas.data_ptr(), *(t.data_ptr() for t in tensors), arrays[5], arrays[6],
        tensors[0].shape[0], C, threads, vals.data_ptr(), grads.data_ptr(), None)
    assert err == 0
    return vals, grads


def plain_fused(model, x, y, thetas):
    arrays = prepare_data(model, x, y)
    tensors = [torch.as_tensor(a) for a in arrays[:5]]
    vals, grads = make_vg(model, *arrays)(thetas.T.contiguous(), *tensors)
    return vals[0], grads.T


# ---- the fused log-posterior on 1, 2, 4 or 8 lanes a chain ----

@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["iris_subset", "xor", "deep"])
def test_fused_vg_on_lanes_equals_the_plain_version(build, name, lanes):  # noqa: F811
    """37 chains in blocks of 32 threads: several blocks, the last one
    holding 5 chains (1 on 8 lanes) and threads of no chain. Every chain's
    value and gradient, read from and written to ``[C, P]``, against
    ``make_vg`` (rtol 2e-5 and the case's atol, chip_smoke.py's gates)."""
    model, x, y, atol = fused_problem(name)
    lib = fused_mlp.bind(build(*fused_mlp.library_spec(model, lanes)[1:]))
    assert lib.fused_mlp_vg_lanes() == lanes
    C = 37
    thetas = torch.as_tensor(np.random.default_rng(5).normal(size=(C, model.num_params)),
                             dtype=torch.float32)
    vals, grads = launch_fused(lib, model, x, y, thetas, 32)
    want_vals, want_grads = plain_fused(model, x, y, thetas)
    torch.testing.assert_close(vals, want_vals, rtol=2e-5, atol=atol)
    torch.testing.assert_close(grads, want_grads, rtol=2e-5, atol=atol)
    # a launch of threads that are no multiple of 32, or of no chain, is refused
    for threads, n in ((48, C), (32, 0)):
        assert lib.fused_mlp_vg_launch(thetas.data_ptr(), *[None] * 5, 0.0, 1.0, 8, n, threads,
                                       None, None, None) != 0


def test_fused_vg_equals_jaxs_kernel_in_interpret_mode(build):  # noqa: F811
    """The build the function takes on the 30-row iris subset (32 padded
    rows: ``FUSED_LANES`` lanes a chain), 128 chains, against JAX's
    ``make_fused_log_target_vg(interpret=True)`` in float32, to rtol 2e-5
    and atol 1e-4 (tests/test_ops.py::compare's gates)."""
    import jax.numpy as jnp

    from eeyore_tpu.models import MLP as JMLP
    from eeyore_tpu.models import loss_functions as jloss_functions
    from eeyore_tpu.models import mlp as jmlp
    from eeyore_tpu.ops.fused_mlp import make_fused_log_target_vg

    model, x, y, atol = fused_problem("iris_subset")
    lanes = fused_mlp.fused_lanes(prepare_data(model, x, y)[0].shape[0])
    assert lanes == fused_mlp.FUSED_LANES
    lib = fused_mlp.bind(build(*fused_mlp.library_spec(model, lanes)[1:]))
    C = 128
    thetas = np.random.default_rng(6).normal(size=(C, model.num_params)).astype(np.float32)
    vals, grads = launch_fused(lib, model, x, y, torch.as_tensor(thetas), 256)
    jm = JMLP(loss=jloss_functions["multiclass_classification"], dtype=jnp.float32,
              hparams=jmlp.Hyperparameters(dims=[4, 3, 3], activations=[jmlp.sigmoid, None]))
    jv, jg = make_fused_log_target_vg(jm, np.asarray(x, np.float32), np.asarray(y, np.float32),
                                      chain_block=C, interpret=True)(jnp.asarray(thetas))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=2e-5, atol=atol)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jg), rtol=2e-5, atol=atol)


# ---- the SMC closure pass, one thread a particle ----

MIX_MU, MIX_S, MIX_BASE = 3.0, 0.25, 3.0  # benchmarks/validate_smc_hard.py:177-201


def mixture_log_pdf(t, x, y):
    """Equal-weight normalized 2-d mixture of N((+-mu, 0), s^2 I)."""
    c = -math.log(2 * math.pi * MIX_S ** 2) - math.log(2.0)
    centre = torch.tensor([MIX_MU, 0.0], dtype=t.dtype, device=t.device)
    d1, d2 = ((t - centre) ** 2).sum(-1), ((t + centre) ** 2).sum(-1)
    return torch.logaddexp(c - 0.5 * d1 / MIX_S ** 2, c - 0.5 * d2 / MIX_S ** 2)


def mixture_base(t):
    return -math.log(2 * math.pi * MIX_BASE ** 2) - 0.5 * (t * t).sum(-1) / MIX_BASE ** 2


@pytest.mark.parametrize("mutation", ["MALA", "MH"])
def test_smc_closure_pass_equals_the_plain_version(build, mutation):  # noqa: F811
    """Three mutation steps of 64 base draws of chip_smoke.py's 2-d mixture
    at beta 0.3 in two blocks: final theta, pot (the untempered
    log-likelihood of the accepted state) and accept counts against the
    plain pass."""
    dm = DistributionModel(mixture_log_pdf, 2, dtype=torch.float32, device="cpu")
    N, steps = 64, 3
    fn = resident_smc.make_resident_smc_mutation(dm, *EMPTY, 0.05, steps, chain_block=N,
                                                 mutation=mutation, base_log_pdf=mixture_base,
                                                 device="cpu")
    programs = resident_smc.closure_programs(dm, *EMPTY, mixture_base, "cpu")
    lib = resident_smc.bind_closure(build(*resident_smc.closure_library_spec(programs)[1:]))
    theta0s = torch.as_tensor(MIX_BASE * np.random.default_rng(4).normal(size=(N, 2)),
                              dtype=torch.float32)
    want, _ = fn.plain(13, 0.3, theta0s)
    # the maker's own setup (its closure's other cells are empty off the card)
    cells = dict(zip(fn.transposed.__code__.co_freevars, fn.transposed.__closure__))
    pr, theta = cells["setup"].cell_contents(13, 0.3, theta0s.T)
    final, pot, accepts = torch.zeros((2, N)), torch.zeros(N), torch.zeros(N)
    threads = resident_smc.smc_threads(1, 1024, N) // 2  # two blocks
    err = lib.resident_smc_closure_launch(resident_smc.MOVES[mutation], theta.data_ptr(),
                                          ctypes.byref(pr), threads, final.data_ptr(),
                                          pot.data_ptr(),
                                          accepts.data_ptr(), None)
    assert err == 0
    assert max_err((final.T, pot), want[:2]) < 2e-4
    assert torch.equal(accepts, want[2])
    assert 0 < int(accepts.sum()) < steps * N


def test_fused_vg_on_lr_equals_the_plain_version_and_jax(build):  # noqa: F811
    """LR(6, 1) on 40 banknote rows, the build the function takes (40 rows:
    ``FUSED_LANES`` lanes a chain, one layer), 64 chains: against ``make_vg``
    and JAX's ``make_fused_log_target_vg(interpret=True)`` in float32, to
    rtol 2e-5 and atol 1e-4."""
    import jax.numpy as jnp

    from eeyore_tpu.models import LogisticRegression as JLogisticRegression
    from eeyore_tpu.models import logistic_regression as jlr
    from eeyore_tpu.models import loss_functions as jloss_functions
    from eeyore_tpu.ops.fused_mlp import make_fused_log_target_vg

    model, (x, y) = problem("banknotes40")
    lanes = fused_mlp.fused_lanes(prepare_data(model, x, y)[0].shape[0])
    assert lanes == fused_mlp.FUSED_LANES
    lib = fused_mlp.bind(build(*fused_mlp.library_spec(model, lanes)[1:]))
    C = 64
    thetas = np.random.default_rng(7).normal(size=(C, model.num_params)).astype(np.float32)
    vals, grads = launch_fused(lib, model, x, y, torch.as_tensor(thetas), 128)
    want_vals, want_grads = plain_fused(model, x, y, torch.as_tensor(thetas))
    torch.testing.assert_close(vals, want_vals, rtol=2e-5, atol=1e-4)
    torch.testing.assert_close(grads, want_grads, rtol=2e-5, atol=1e-4)
    jm = JLogisticRegression(jloss_functions["binary_classification"], dtype=jnp.float32,
                             hparams=jlr.Hyperparameters(6, 1))
    jv, jg = make_fused_log_target_vg(jm, np.asarray(x, np.float32), np.asarray(y, np.float32),
                                      chain_block=C, interpret=True)(jnp.asarray(thetas))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jg), rtol=2e-5, atol=1e-4)
