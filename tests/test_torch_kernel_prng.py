"""Port parity, kernel random numbers: the plain PyTorch Threefry-2x32 bit
for bit against ``jax.extend.random.threefry_2x32``; uniforms from edge bit
patterns in (0, 1]; the polynomial sincos against the JAX package's
``sincos_2pi`` (float32, 1e-6) and against ``torch.cos`` / ``torch.sin``
(3e-7, the bound tests/test_ops.py pins); and the moments of the normals and
of the HMC stream. The CUDA functions of ``csrc/kernel_prng.cuh`` are held
against these through the resident kernel in ``chip_smoke.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from eeyore_tpu.ops.kernel_prng import sincos_2pi as jax_sincos_2pi
from eeyore_tpu_torch.ops import kernel_prng


@pytest.mark.parametrize("key", [(0, 0), (1234, 7), (0xFFFFFFFF, 0x80000000), (42, 0xDEADBEEF)])
def test_threefry_bit_exact_against_jax(key):
    rng = np.random.default_rng(key[1] % 1000)
    count = rng.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    count[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(threefry_2x32((np.uint32(key[0]), np.uint32(key[1])), count))
    y0, y1 = kernel_prng.threefry2x32(key[0], key[1], torch.as_tensor(count[:32].astype(np.int64)),
                                      torch.as_tensor(count[32:].astype(np.int64)))
    got = np.concatenate([y0.numpy(), y1.numpy()])
    assert got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_threefry_broadcasts_keys_and_counters():
    """A [J, C] grid of (key1, counter) pairs equals the per-key calls."""
    chains = torch.arange(5, dtype=torch.int64)
    j = torch.arange(3, dtype=torch.int64)[:, None]
    y0, y1 = kernel_prng.threefry2x32(9, chains[None, :], 4, j)
    assert y0.shape == (3, 5)
    for c in range(5):
        for jj in range(3):
            want = np.asarray(threefry_2x32((np.uint32(9), np.uint32(c)),
                                            np.array([4, jj], dtype=np.uint32)))
            assert (int(y0[jj, c]), int(y1[jj, c])) == tuple(int(w) for w in want)


def test_uniform_edges_in_half_open_unit_interval():
    u = kernel_prng.uniform(torch.tensor([0, 0xFFFFFFFF, 0x1FF, 0x200, 0x80000000]))
    assert u.dtype == torch.float32
    assert float(u[0]) == 1.0                      # all-zero mantissa: 1 - 0
    assert float(u[1]) == pytest.approx(2.0**-23)  # smallest value, never 0
    assert float(u[2]) == 1.0                      # the 9 low bits are dropped
    assert float(u[3]) == 1.0 - 2.0**-23
    assert float(u[4]) == 0.5
    bits = torch.as_tensor(np.random.default_rng(0).integers(0, 2**32, 10000, dtype=np.int64))
    u = kernel_prng.uniform(bits)
    assert bool(((u > 0) & (u <= 1)).all())


def test_sincos_matches_jax_and_torch():
    u = np.concatenate([np.random.default_rng(1).uniform(0, 1, 20000),
                        [1.0, 0.25, 0.5, 0.75, 2.0**-23, 1.0 - 2.0**-23]]).astype(np.float32)
    c, s = kernel_prng.sincos_2pi(torch.as_tensor(u))
    jc, js = jax_sincos_2pi(jnp.asarray(u))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    angle = 2.0 * math.pi * torch.as_tensor(u, dtype=torch.float64)
    assert (c.double() - torch.cos(angle)).abs().max() <= 3e-7
    assert (s.double() - torch.sin(angle)).abs().max() <= 3e-7


def test_normal_moments():
    """Box-Muller on both halves: mean 0, variance 1, uncorrelated halves,
    kurtosis 3, within the Monte-Carlo error of 2e5 draws."""
    rng = np.random.default_rng(2)
    b0, b1 = (torch.as_tensor(rng.integers(0, 2**32, 200000, dtype=np.int64)) for _ in range(2))
    z0, z1 = kernel_prng.normal(b0, b1)
    for z in (z0, z1):
        z = z.double()
        assert abs(z.mean().item()) < 0.015
        assert abs(z.var().item() - 1.0) < 0.015
        assert abs((z**4).mean().item() - 3.0) < 0.08
    assert abs((z0.double() * z1.double()).mean().item()) < 0.015


def test_hmc_draws_layout_and_moments():
    """Momentum pairs (2j, 2j+1) come from counter (t, j), the accept
    uniform from j = ceil(P/2), the rounding uniform from j = ceil(P/2)+1."""
    P, C, t, seed = 27, 4096, 5, 11
    chains = torch.arange(C, dtype=torch.int64)
    mom, u_acc, u_round = kernel_prng.hmc_draws(seed, chains, t, P)
    assert mom.shape == (P, C) and u_acc.shape == (C,) and u_round.shape == (C,)
    y0, y1 = kernel_prng.threefry2x32(seed, chains, t, 3)
    z0, z1 = kernel_prng.normal(y0, y1)
    torch.testing.assert_close(mom[6], z0, rtol=0, atol=0)
    torch.testing.assert_close(mom[7], z1, rtol=0, atol=0)
    pairs = (P + 1) // 2
    torch.testing.assert_close(u_acc, kernel_prng.uniform(
        kernel_prng.threefry2x32(seed, chains, t, pairs)[0]), rtol=0, atol=0)
    torch.testing.assert_close(u_round, kernel_prng.uniform(
        kernel_prng.threefry2x32(seed, chains, t, pairs + 1)[0]), rtol=0, atol=0)
    assert abs(mom.double().mean().item()) < 0.01
    assert abs(mom.double().var().item() - 1.0) < 0.01
    assert abs(u_acc.double().mean().item() - 0.5) < 0.015
    # another iteration or seed gives other numbers
    assert not torch.equal(kernel_prng.hmc_draws(seed, chains, t + 1, P)[0], mom)
    assert not torch.equal(kernel_prng.hmc_draws(seed + 1, chains, t, P)[0], mom)
