"""The whole-loop kernels' random stream, worked out from the seed alone.

A frozen copy of the stream's definition: Threefry-2x32 with 20 rounds,
keyed by (kernel seed, global chain index) and counted by (iteration, word).
Bits are carried in int64 tensors holding values in [0, 2**32). The kernel
seed is the first ``torch.randint(0, 2**31 - 1, (1,))`` drawn from the
generator handed to ``sample_chains`` (``kernel_seed``).

Word layout of one iteration of one chain, P parameters, ``pairs =
ceil(P/2)``:

- HMC: words j < pairs are Box-Muller pairs (momenta 2j and 2j+1), word
  ``pairs`` the accept uniform, ``pairs + 1`` the stochastic-rounding one.
- MH and MALA: words j < pairs the proposal normals, word ``pairs`` the
  accept uniform.
- fixed-budget NUTS: words j < pairs the momenta; then for each depth d the
  direction uniform, the 2**d leaf uniforms and the merge uniform, from word
  ``pairs + 2**d - 1 + 2d``; every NUTS uniform is ``1 - uniform``.

The draws come out in float32, as the kernels compute them.
"""

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def kernel_seed(generator_seed, device):
    """The seed the kernel path takes from a generator seeded with
    ``generator_seed`` on ``device``'s type."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(generator_seed))
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=device))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key0, key1, x0, x1):
    """Threefry-2x32, 20 rounds, of the counter (x0, x1) under (key0, key1)."""
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
    """(0, 1] float32 uniforms: 23 high bits under the exponent of 1.0."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return 1.0 - f


def _sincos_2pi(u):
    """(cos 2 pi u, sin 2 pi u) by quadrant reduction and Taylor polynomials
    in float32, as the kernels compute them."""
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
    qm = qi & 3
    neg_c = (qm == 1) | (qm == 2)
    neg_s = qm >= 2
    return torch.where(neg_c, -base_c, base_c), torch.where(neg_s, -base_s, base_s)


def _normal(bits0, bits1):
    r = torch.sqrt(-2.0 * torch.log(uniform(bits0)))
    cos, sin = _sincos_2pi(uniform(bits1))
    return r * cos, r * sin


def _words(seed, chains, iterations, first, count):
    """Words [count, B] of the pairs (chains[b], iterations[b])."""
    j = first + torch.arange(count, dtype=torch.int64, device=chains.device)[:, None]
    return threefry2x32(seed, chains[None, :], iterations[None, :], j)


def _normals(y0, y1, num_params):
    z0, z1 = _normal(y0, y1)
    return torch.stack([z0, z1], dim=1).reshape(2 * y0.shape[0], -1)[:num_params]


def walk_draws(seed, chains, iterations, num_params):
    """MH/MALA draws of (chain, iteration) pairs: (normals [P, B], accept
    uniforms [B]), float32."""
    pairs = (num_params + 1) // 2
    y0, y1 = _words(seed, chains, iterations, 0, pairs + 1)
    return _normals(y0[:pairs], y1[:pairs], num_params), uniform(y0[pairs])


def hmc_draws(seed, chains, iterations, num_params):
    """HMC draws: (momenta [P, B], accept uniforms [B], rounding uniforms
    [B]), float32."""
    pairs = (num_params + 1) // 2
    y0, y1 = _words(seed, chains, iterations, 0, pairs + 2)
    return (_normals(y0[:pairs], y1[:pairs], num_params), uniform(y0[pairs]),
            uniform(y0[pairs + 1]))


def nuts_word(num_params, depth):
    return (num_params + 1) // 2 + (1 << depth) - 1 + 2 * depth


def nuts_draws(seed, chains, iterations, num_params, max_depth):
    """Fixed-budget NUTS draws: (momenta [P, B], direction uniforms [D, B],
    leaf uniforms [D tensors [2**d, B]], merge uniforms [D, B]), uniforms in
    [0, 1), float32."""
    pairs = (num_params + 1) // 2
    y0, y1 = _words(seed, chains, iterations, 0, pairs)
    normals = _normals(y0, y1, num_params)
    first = nuts_word(num_params, 0)
    u0, _ = _words(seed, chains, iterations, first, nuts_word(num_params, max_depth) - first)
    u = 1.0 - uniform(u0)
    directions, leaves, merges = [], [], []
    for d in range(max_depth):
        w = nuts_word(num_params, d) - first
        directions.append(u[w])
        leaves.append(u[w + 1:w + 1 + (1 << d)])
        merges.append(u[w + 1 + (1 << d)])
    return normals, torch.stack(directions), leaves, torch.stack(merges)
