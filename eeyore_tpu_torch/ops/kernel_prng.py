"""Counter-based random numbers for the whole-loop kernels.

Counterpart of ``eeyore_tpu/ops/kernel_prng.py``. The TPU kernels draw from
the core's own generator, whose bits cannot be reproduced elsewhere; the port
uses Threefry-2x32 with 20 rounds (the hash behind ``jax.random``), so the
CUDA kernels (``csrc/kernel_prng.cuh``, the same functions as device code)
and their plain PyTorch versions here draw the same numbers. Parity with the
JAX package's kernels is statistical, as theirs was with its scanned path.

Bits are carried in int64 tensors holding values in [0, 2**32); every add
and shift is masked back to 32 bits.

The stream of the HMC kernel (``hmc_draws``): key = (seed, global chain
index), counter = (iteration, j). For j < ceil(P/2) the two words are one
Box-Muller pair, momenta 2j and 2j+1; j = ceil(P/2) gives the accept uniform
and j = ceil(P/2) + 1 the stochastic-rounding uniform.

The stream of the walk kernels (``walk_draws``) has the same layout: for j <
ceil(P/2) the pairs of proposal normals, and j = ceil(P/2) the accept
uniform. (The JAX package's dense kernels draw with ``normal_tiles`` from the
TPU core's generator; its numbers cannot be reproduced, so that function has
no counterpart here.)

The SMC mutation pass (``ops/resident_smc.py``, ``csrc/resident_smc.cu``)
draws from the walk stream too: key = (stage seed, particle index), counter =
(mutation step, j), for j < ceil(P/2) the Box-Muller pairs of the proposal
normals and j = ceil(P/2) the accept uniform, so its plain version calls
``walk_draws``.

The stream of the tempering moves (``tempering_draws``) is the walk stream
and one word more: j = ceil(P/2) + 1 gives the swap uniform, which only the
lower member of a swap pair tests. ``walk_draws`` is its prefix, so a walk
run draws what it drew before.

The stream of the blocked Gibbs moves (``gibbs_draws``), the same for the
staged and the dense kernel: key = (seed, global chain index), counter =
(iteration, b * 2**16 + j) for sub-block b of the sweep. For j < ceil(w/2),
with w the sub-block's width, the two words are the Box-Muller pair of
proposal normals 2j and 2j+1; j = ceil(w/2) gives the accept uniform. A sweep
has fewer than 2**16 sub-blocks, each narrower than 2**17 coordinates.

The stream of the fixed-budget NUTS kernels (``nuts_draws``), the same for
the staged and the dense kernel: key = (seed, global chain index), counter =
(iteration, j). For j < ceil(P/2) the two words are the Box-Muller pair of
momenta 2j and 2j+1. Then, for each depth d = 0 .. D-1 in order, from word
ceil(P/2) + (2**d - 1) + 2d: the direction uniform (right when u < 1/2), the
2**d leaf uniforms of the subtree's multinomial draws, and the merge
uniform. Every NUTS uniform is ``1 - uniform``, in [0, 1), as the JAX
kernels' ``u01`` (``resident_nuts_dense.py:101-106``): log(u) < 0 then
holds for every draw, so the first live leaf of a subtree is always taken.
"""

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key0, key1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter (x0, x1) under the key
    (key0, key1): int64 tensors or ints of 32-bit values, broadcast
    together. Returns the two output words as int64 tensors."""
    k0 = torch.as_tensor(key0, dtype=torch.int64) & MASK32
    k1 = torch.as_tensor(key1, dtype=torch.int64) & MASK32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (torch.as_tensor(x0, dtype=torch.int64) + ks[0]) & MASK32
    x1 = (torch.as_tensor(x1, dtype=torch.int64) + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def uniform(bits):
    """(0, 1] float32 uniforms from 32-bit words, by the mantissa fill of
    the JAX kernels: 23 high bits under the exponent of 1.0 give [1, 2)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return 1.0 - f


def sincos_2pi(u):
    """(cos(2 pi u), sin(2 pi u)) for u in (0, 1] by quadrant reduction and
    Taylor polynomials in w = (pi/2) frac(4u), as the JAX kernels compute
    it (absolute error about 3e-7 in float32)."""
    v = 4.0 * u
    q = torch.floor(v)
    t = v - q
    qi = q.to(torch.int32)
    z = t * t
    a = (math.pi / 2.0) ** 2
    c = 1.0 + z * (-a / 2.0 + z * (a * a / 24.0 + z * (
        -a**3 / 720.0 + z * (a**4 / 40320.0 + z * (
            -a**5 / 3628800.0 + z * (a**6 / 479001600.0))))))
    s = (t * (math.pi / 2.0)) * (1.0 + z * (-a / 6.0 + z * (
        a * a / 120.0 + z * (-a**3 / 5040.0 + z * (
            a**4 / 362880.0 + z * (-a**5 / 39916800.0))))))
    odd = (qi & 1) == 1
    base_c = torch.where(odd, s, c)
    base_s = torch.where(odd, c, s)
    qm = qi & 3  # u == 1 gives q = 4: quadrant 0 with t = 0
    neg_c = (qm == 1) | (qm == 2)
    neg_s = qm >= 2
    return torch.where(neg_c, -base_c, base_c), torch.where(neg_s, -base_s, base_s)


def normal(bits0, bits1):
    """Two independent standard normals per pair of words, by Box-Muller on
    both halves: (r cos a, r sin a)."""
    r = torch.sqrt(-2.0 * torch.log(uniform(bits0)))
    cos, sin = sincos_2pi(uniform(bits1))
    return r * cos, r * sin


GIBBS_SUB_BLOCK_STRIDE = 1 << 16


def _draws(seed, chains, iteration, num_params, num_uniforms, first_word=0):
    pairs = (num_params + 1) // 2
    j = first_word + torch.arange(pairs + num_uniforms, dtype=torch.int64,
                                  device=chains.device)[:, None]
    y0, y1 = threefry2x32(seed, chains[None, :], iteration, j)
    z0, z1 = normal(y0[:pairs], y1[:pairs])
    normals = torch.stack([z0, z1], dim=1).reshape(2 * pairs, -1)[:num_params]
    return (normals,) + tuple(uniform(y0[pairs + i]) for i in range(num_uniforms))


def hmc_draws(seed, chains, iteration, num_params):
    """The HMC kernel's draws for one iteration: (momenta [P, C] float32,
    accept uniforms [C], stochastic-rounding uniforms [C]) for the global
    chain indices ``chains`` [C] (int64)."""
    return _draws(seed, chains, iteration, num_params, 2)


def walk_draws(seed, chains, iteration, num_params):
    """The walk kernels' draws for one iteration: (proposal normals [P, C]
    float32, accept uniforms [C]) for the global chain indices ``chains``."""
    return _draws(seed, chains, iteration, num_params, 1)


def tempering_draws(seed, chains, iteration, num_params):
    """The tempering moves' draws for one iteration: (proposal normals [P,
    C] float32, accept uniforms [C], swap uniforms [C]) for the global chain
    indices ``chains``."""
    return _draws(seed, chains, iteration, num_params, 2)


def gibbs_draws(seed, chains, iteration, sub_block, width):
    """The Gibbs kernels' draws for sub-block ``sub_block`` of sweep
    ``iteration``: (proposal normals [width, C] float32, accept uniforms
    [C]) for the global chain indices ``chains``."""
    return _draws(seed, chains, iteration, width, 1,
                  first_word=sub_block * GIBBS_SUB_BLOCK_STRIDE)


def nuts_word(num_params, depth):
    """The first word (the direction uniform) of depth ``depth`` of the NUTS
    stream: ceil(P/2) + (2**depth - 1) + 2 depth."""
    return (num_params + 1) // 2 + (1 << depth) - 1 + 2 * depth


def nuts_draws(seed, chains, iteration, num_params, max_depth):
    """The NUTS kernels' draws for one iteration, for the global chain
    indices ``chains`` [C] (int64): (momentum normals [P, C] float32,
    direction uniforms [D, C], leaf uniforms [D tensors of [2**d, C]], merge
    uniforms [D, C]), every uniform in [0, 1)."""
    (normals,) = _draws(seed, chains, iteration, num_params, 0)
    j = torch.arange(nuts_word(num_params, max_depth) - nuts_word(num_params, 0),
                     dtype=torch.int64, device=chains.device)[:, None]
    y0, _ = threefry2x32(seed, chains[None, :], iteration, nuts_word(num_params, 0) + j)
    u = 1.0 - uniform(y0)
    directions, leaves, merges = [], [], []
    for d in range(max_depth):
        first = nuts_word(num_params, d) - nuts_word(num_params, 0)
        directions.append(u[first])
        leaves.append(u[first + 1:first + 1 + (1 << d)])
        merges.append(u[first + 1 + (1 << d)])
    return normals, torch.stack(directions), leaves, torch.stack(merges)
