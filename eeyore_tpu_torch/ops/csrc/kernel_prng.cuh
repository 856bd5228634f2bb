// Counter-based random numbers for the whole-loop kernels, as device code.
//
// The same functions as eeyore_tpu_torch/ops/kernel_prng.py, which is their
// plain PyTorch version and documents the stream: Threefry-2x32 with 20
// rounds, (0, 1] uniforms by mantissa fill, the polynomial sincos of a
// uniform angle and Box-Muller on both halves. Precise logf and sqrtf, no
// fast-math intrinsics, so that a kernel and its plain version draw the same
// numbers up to f32 rounding. The HMC stream (hmc_draws) and the walk stream
// (walk_draws) share their layout: key (seed, chain), counter (iteration, j).
// The Gibbs stream (gibbs_draws) offsets j by b * kGibbsStride for sub-block
// b of the sweep. The NUTS stream (nuts_draws) takes the momenta from words j <
// ceil(P/2) and then, depth by depth, a direction, 2^d leaf and one merge
// uniform, each in [0, 1) (u01_at).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace kernel_prng {

__device__ __forceinline__ unsigned rotl32(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, of the counter (x0, x1) under the key (k0, k1).
__device__ __forceinline__ uint2 threefry2x32(unsigned k0, unsigned k1, unsigned x0,
                                              unsigned x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][r]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<unsigned>(i + 1);
  }
  return make_uint2(x0, x1);
}

// (0, 1] uniform from 32 bits: 23 high bits under the exponent of 1.0.
__device__ __forceinline__ float uniform(unsigned bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return 1.0f - f;
}

// (cos(2 pi u), sin(2 pi u)) for u in (0, 1]: quadrant reduction and Taylor
// polynomials in w = (pi/2) frac(4u); the coefficients are those of the JAX
// kernels, computed in double and rounded to float.
__device__ __forceinline__ void sincos_2pi(float u, float* cos_out, float* sin_out) {
  constexpr double kA = (3.14159265358979323846 / 2.0) * (3.14159265358979323846 / 2.0);
  constexpr float c1 = static_cast<float>(-kA / 2.0);
  constexpr float c2 = static_cast<float>(kA * kA / 24.0);
  constexpr float c3 = static_cast<float>(-kA * kA * kA / 720.0);
  constexpr float c4 = static_cast<float>(kA * kA * kA * kA / 40320.0);
  constexpr float c5 = static_cast<float>(-kA * kA * kA * kA * kA / 3628800.0);
  constexpr float c6 = static_cast<float>(kA * kA * kA * kA * kA * kA / 479001600.0);
  constexpr float s1 = static_cast<float>(-kA / 6.0);
  constexpr float s2 = static_cast<float>(kA * kA / 120.0);
  constexpr float s3 = static_cast<float>(-kA * kA * kA / 5040.0);
  constexpr float s4 = static_cast<float>(kA * kA * kA * kA / 362880.0);
  constexpr float s5 = static_cast<float>(-kA * kA * kA * kA * kA / 39916800.0);
  constexpr float half_pi = static_cast<float>(3.14159265358979323846 / 2.0);
  const float v = 4.0f * u;
  const float q = floorf(v);
  const float t = v - q;
  const int qi = static_cast<int>(q);
  const float z = t * t;
  const float c = 1.0f + z * (c1 + z * (c2 + z * (c3 + z * (c4 + z * (c5 + z * c6)))));
  const float s = (t * half_pi) * (1.0f + z * (s1 + z * (s2 + z * (s3 + z * (s4 + z * s5)))));
  const bool odd = (qi & 1) == 1;
  const float base_c = odd ? s : c;
  const float base_s = odd ? c : s;
  const int qm = qi & 3;  // u == 1 gives q = 4: quadrant 0 with t = 0
  *cos_out = (qm == 1 || qm == 2) ? -base_c : base_c;
  *sin_out = qm >= 2 ? -base_s : base_s;
}

// Two independent standard normals from one pair of words (Box-Muller).
__device__ __forceinline__ void normal2(uint2 bits, float* z0, float* z1) {
  const float r = sqrtf(-2.0f * logf(uniform(bits.x)));
  float c, s;
  sincos_2pi(uniform(bits.y), &c, &s);
  *z0 = r * c;
  *z1 = r * s;
}

constexpr unsigned kGibbsStride = 1u << 16;

// The P normals of one chain at one iteration of the HMC and walk streams
// (key (k0, k1), counter (ctr, first + j)): pair j gives z[2j] and z[2j+1],
// for j < ceil(P/2); an odd P drops the last half. first is 0 but for the
// Gibbs stream.
template <int P>
__device__ __forceinline__ void normals(unsigned k0, unsigned k1, unsigned ctr, float (&z)[P],
                                        unsigned first = 0) {
#pragma unroll
  for (int j = 0; j < (P + 1) / 2; ++j) {
    float z0, z1;
    normal2(threefry2x32(k0, k1, ctr, first + static_cast<unsigned>(j)), &z0, &z1);
    z[2 * j] = z0;
    if (2 * j + 1 < P) z[2 * j + 1] = z1;
  }
}

// The uniform of word j of the stream (the accept test: j = ceil(P/2)).
__device__ __forceinline__ float uniform_at(unsigned k0, unsigned k1, unsigned ctr, unsigned j) {
  return uniform(threefry2x32(k0, k1, ctr, j).x);
}

// The [0, 1) uniform of word j, 1 - uniform_at: the NUTS kernels' draws
// (log(u) < 0 holds for every one of them).
__device__ __forceinline__ float u01_at(unsigned k0, unsigned k1, unsigned ctr, unsigned j) {
  return 1.0f - uniform_at(k0, k1, ctr, j);
}

}  // namespace kernel_prng
