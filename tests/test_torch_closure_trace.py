"""Port, ``ops/closure_trace.py``: the body that
``csrc/resident_smc_closure.cu`` runs for a ``DistributionModel`` target.
On closures of the forms the SMC paths use (the 2-d mixture of
benchmarks/validate_smc_hard.py, a correlated normal by a matrix product, a
logistic regression on captured data, and two that between them use every
operation the tracer lowers), the
traced program, interpreted in numpy float32, equals the closure's batched
autograd (``resident_smc.make_generic_vg``, the kernel's plain version;
float32: 1e-5), and the generated source, compiled for the host with the
device qualifiers defined away, equals the program (1e-5 relative: the C
library's and numpy's transcendental functions differ by an ulp). The CUDA
build itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from eeyore_tpu_torch.models import DistributionModel
from eeyore_tpu_torch.ops import closure_trace, resident_smc

RNG = np.random.default_rng(11)
DATA_X = RNG.normal(size=(6, 2))
DATA_Y = np.array([[0.], [1.], [1.], [0.], [1.], [0.]])
EMPTY = (np.zeros((1, 0)), np.zeros((1, 0)))
PREC = torch.tensor([[1.0, 0.5], [0.5, 1.0]])


def mixture(t, x, y):
    c = -math.log(2 * math.pi * 0.25 ** 2) - math.log(2.0)
    centre = torch.tensor([3.0, 0.0], dtype=t.dtype, device=t.device)
    d1, d2 = ((t - centre) ** 2).sum(-1), ((t + centre) ** 2).sum(-1)
    return torch.logaddexp(c - 0.5 * d1 / 0.25 ** 2, c - 0.5 * d2 / 0.25 ** 2)


def correlated_normal(t, x, y):
    return -0.5 * (((t - 1.0) @ PREC) * (t - 1.0)).sum(-1)


def logistic_regression(t, x, y):
    z = t[..., :2] @ x.T + t[..., 2:3]
    return (y[:, 0] * torch.log(torch.sigmoid(z))
            + (1 - y[:, 0]) * torch.log(torch.sigmoid(-z))).sum(-1)


def elementwise(t, x, y):
    a = torch.where(t > 0, t, -2 * t).sum(-1)
    b = torch.tanh(t).mean(-1) + torch.clamp(t, -1.0, 1.0).amax(-1)
    c = torch.sqrt(t * t + 1).sum(-1) + (t ** 3).sum(-1) / 10 + torch.logsumexp(t, -1)
    d = torch.nn.functional.softplus(t).sum(-1) + torch.abs(t).sum(-1)
    return a + b + c + d + torch.exp(-t * t).sum(-1)


def more_operations(t, x, y):
    u = torch.stack([t[..., 0], t[..., 1] * 2.0], -1)
    v = torch.cat([u, t[..., 2:]], -1)
    # a vector product: a dot product when traced for one particle
    a = v @ torch.tensor([0.5, -1.0, 2.0]) + torch.maximum(t, -t).sum(-1) \
        + torch.minimum(t, 1.0 - t).sum(-1)
    b = torch.expm1(-t * t).sum(-1) + torch.sin(t).sum(-1) * torch.cos(t).sum(-1)
    c = torch.reciprocal(t * t + 1).sum(-1) + torch.rsqrt(t * t + 2).sum(-1) + t.amin(-1)
    mask = torch.logical_or(t < -1, torch.logical_not(t != 0.5))
    d = torch.where(mask, torch.zeros_like(t), torch.full_like(t, 0.25) * t).sum(-1)
    e = (t.unsqueeze(-2).transpose(-1, -2) @ t.unsqueeze(-2)).sum((-1, -2))
    return a + b + c + d + e + (t > 0).float().sum(-1)


def normal_base(scale):
    return lambda t: -math.log(2 * math.pi * scale ** 2) - 0.5 * (t * t).sum(-1) / scale ** 2


CLOSURES = {
    "mixture": (mixture, 2, EMPTY),
    "correlated_normal": (correlated_normal, 2, EMPTY),
    "logistic_regression": (logistic_regression, 3, (DATA_X, DATA_Y)),
    "elementwise": (elementwise, 3, EMPTY),
    "more_operations": (more_operations, 3, EMPTY),
}


def programs(name):
    log_pdf, P, (x, y) = CLOSURES[name]
    dm = DistributionModel(log_pdf, P, dtype=torch.float32, device="cpu")
    return dm, x, y, resident_smc.closure_programs(dm, x, y, normal_base(3.0), "cpu")


def interpret(prog, theta):
    """The program's outputs on theta [N, P] (float32), each [N]."""
    env = {f"th[{p}]": theta[:, p] for p in range(prog.num_params)}

    def value(a):
        return env[a] if isinstance(a, str) else a

    for name, op, args in prog.statements:
        env[name] = closure_trace.fold(op, *map(value, args))
    return [np.broadcast_to(value(o), theta.shape[:1]) for o in prog.outputs]


def particles(P, n=256):
    return (1.5 * RNG.normal(size=(n, P))).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CLOSURES))
@pytest.mark.parametrize("with_grad", [False, True])
def test_program_equals_the_closures_autograd(name, with_grad):
    dm, x, y, progs = programs(name)
    prog = progs[int(with_grad)]
    theta = particles(dm.num_params)
    got = interpret(prog, theta)
    vg = resident_smc.make_generic_vg(dm, x, y, normal_base(3.0), with_grad, device="cpu")
    want = [w.numpy() for out in vg(torch.as_tensor(theta.T.copy())) for w in out]
    assert len(got) == len(want) == (2 + 2 * dm.num_params if with_grad else 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


HOST_SHIM = """
#include <cmath>
#include <math.h>
#define __device__
#define __forceinline__ inline
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
#include "closure_body.cuh"
using closure_body::kP;
extern "C" void run_v(int n, const float* th, float* out) {
  for (int i = 0; i < n; ++i) {
    float t[kP];
    for (int p = 0; p < kP; ++p) t[p] = th[i * kP + p];
    const float2 r = closure_body::v(t);
    out[2 * i] = r.x;
    out[2 * i + 1] = r.y;
  }
}
extern "C" void run_vg(int n, const float* th, float* out) {
  for (int i = 0; i < n; ++i) {
    float t[kP], gll[kP], glp[kP];
    for (int p = 0; p < kP; ++p) t[p] = th[i * kP + p];
    const float2 r = closure_body::vg(t, gll, glp);
    float* o = out + i * (2 + 2 * kP);
    o[0] = r.x;
    o[1] = r.y;
    for (int p = 0; p < kP; ++p) {
      o[2 + p] = gll[p];
      o[2 + kP + p] = glp[p];
    }
  }
}
"""


@pytest.mark.parametrize("name", sorted(CLOSURES))
def test_generated_source_equals_the_program(name, tmp_path):
    """The printed C of both functions, compiled for the host without
    contraction, computes what the statements say."""
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("no host C++ compiler to build the generated source with")
    dm, _, _, progs = programs(name)
    (tmp_path / "closure_body.cuh").write_text(closure_trace.cuda_source(*progs))
    (tmp_path / "shim.cpp").write_text(HOST_SHIM)
    lib_path = tmp_path / "closure_host.so"
    subprocess.run([compiler, "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                    f"-I{tmp_path}", str(tmp_path / "shim.cpp"), "-o", str(lib_path)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    P = dm.num_params
    theta = particles(P, 64)
    for fn, prog, width in ((lib.run_v, progs[0], 2), (lib.run_vg, progs[1], 2 + 2 * P)):
        out = np.zeros((len(theta), width), np.float32)
        fn(ctypes.c_int(len(theta)), theta.ctypes.data_as(ctypes.c_void_p),
           out.ctypes.data_as(ctypes.c_void_p))
        for got, want in zip(out.T, interpret(prog, theta)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_unlowerable_closures_raise_and_name_the_operation():
    def sorted_max(t, x, y):
        return torch.sort(t, dim=-1)[0][..., -1]

    def double(t, x, y):
        return (t.double() ** 2).sum(-1).float()

    for log_pdf, match in ((sorted_max, "sort"), (double, "float32")):
        dm = DistributionModel(log_pdf, 2, dtype=torch.float32, device="cpu")
        with pytest.raises(ValueError, match=match):
            resident_smc.closure_programs(dm, *EMPTY, normal_base(1.0), "cpu")


def test_constants_fold_and_literals_are_exact():
    dm = DistributionModel(lambda t, x, y: t.sum(-1) * 0.0 + math.log(2.0) * math.pi, 2,
                           dtype=torch.float32, device="cpu")
    prog_v, prog_vg = resident_smc.closure_programs(dm, *EMPTY, lambda t: -(t * t).sum(-1),
                                                    "cpu")
    # the base's gradient -2 t is all the gradient program computes per parameter
    assert all(not isinstance(a, str) or a.startswith(("t", "th[")) for _, _, args in
               prog_vg.statements for a in args)
    assert float(np.float32(0.1)) == float.fromhex(closure_trace._literal(0.1)[:-1])
    assert closure_trace._literal(float("inf")) == "INFINITY"
    assert closure_trace._literal(float("-inf")) == "(-INFINITY)"
    assert closure_trace._literal(float("nan")) == "NAN"
    assert closure_trace._literal(-0.0) == "(-0x0.0p+0f)"
    assert closure_trace._literal(np.bool_(True)) == "true"
    source = closure_trace.cuda_source(prog_v, prog_vg)
    assert "constexpr int kP = 2;" in source and "glp[1] = " in source
    ops, sfu = closure_trace.work(prog_vg)
    assert ops == sum(closure_trace._OPS[op][2][0] for _, op, _ in prog_vg.statements)
    assert sfu == sum(closure_trace._OPS[op][2][1] for _, op, _ in prog_vg.statements)


def test_the_kernels_parameter_count_factors_into_widths():
    assert resident_smc._closure_dims(2) == (2, 1)
    assert resident_smc._closure_dims(255) == (255, 1)
    assert resident_smc._closure_dims(256) == (128, 2)
    with pytest.raises(ValueError, match="at most"):
        resident_smc._closure_dims(257 * 263)
