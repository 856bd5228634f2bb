// Per-chain log-posterior and gradient of a sigmoid MLP, as device code.
//
// The body of the fused value-and-gradient, shared by fused_mlp_vg.cu (one
// evaluation per launch) and the whole-loop kernels on staged data
// (resident_loop.cuh: resident_hmc.cu, resident_walk.cu). One
// thread owns one chain: chain_vg takes the chain's theta in registers and
// returns
//   val  = T * (log_lik(theta) + log_prior(theta))
//   grad = d val / d theta
// with BCE (sigmoid output) or softmax CE (logit output) and an IID Normal
// prior, by a forward pass, the output deltas and a hand-derived backward
// pass over the data rows. The plain PyTorch version is
// eeyore_tpu_torch/ops/mlp_math.py::make_vg. chain_eval_split returns the
// untempered log-likelihood and log-prior apart (make_vg(split=True)), for
// the SMC mutation kernel (resident_smc.cu), whose target tempers the
// likelihood only.
//
// The architecture is fixed at compile time (FMV_* macros below), so every
// loop over units unrolls and theta, the gradient accumulators and the
// activations of one row stay in registers. The data rows and the prior
// constants are staged once per block in shared memory (stage_data), where
// every thread of a warp reads the same word, which is a broadcast. f32
// throughout, with expf, logf and log1pf and no fast-math intrinsics.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// The architecture, as integers (nvcc splits a -D value at commas):
//   FMV_NUM_LAYERS  number of layers L (at most 7)
//   FMV_DIMS        layer widths, input first, 8 bits each: dims[l] = (FMV_DIMS >> 8l) & 255
//   FMV_BIAS        bit l set when layer l has a bias
//   FMV_CE          1: softmax cross-entropy on logits, 0: binary cross-entropy
#if !defined(FMV_NUM_LAYERS) || !defined(FMV_DIMS) || !defined(FMV_BIAS) || !defined(FMV_CE)
#error "FMV_NUM_LAYERS, FMV_DIMS, FMV_BIAS and FMV_CE must be defined"
#endif

namespace mlp_vg {

constexpr int kNumLayers = FMV_NUM_LAYERS;
static_assert(kNumLayers >= 1 && kNumLayers <= 7, "1 to 7 layers");
constexpr bool kCrossEntropy = FMV_CE != 0;

__host__ __device__ constexpr int dim(int l) {
  return static_cast<int>((static_cast<unsigned long long>(FMV_DIMS) >> (8 * l)) & 0xffull);
}
__host__ __device__ constexpr bool has_bias(int l) {
  return ((static_cast<unsigned long long>(FMV_BIAS) >> l) & 1ull) != 0;
}

// Flat-theta layout: per layer, row-major W [dims[l+1], dims[l]], then b.
__host__ __device__ constexpr int w_off(int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += dim(i) * dim(i + 1) + (has_bias(i) ? dim(i + 1) : 0);
  return off;
}
__host__ __device__ constexpr int b_off(int l) { return w_off(l) + dim(l) * dim(l + 1); }
// Offset of layer l's input activations in the per-row activation array.
__host__ __device__ constexpr int act_off(int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += dim(i);
  return off;
}
__host__ __device__ constexpr int max_width() {
  int m = 0;
  for (int l = 0; l <= kNumLayers; ++l) m = dim(l) > m ? dim(l) : m;
  return m;
}

constexpr int kP = w_off(kNumLayers);
constexpr int kIn = dim(0);
constexpr int kOut = dim(kNumLayers);
constexpr int kActs = act_off(kNumLayers + 1);
constexpr int kMaxWidth = max_width();

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// Forward pass of layers L.. for one row; a[act_off(l) + i] holds layer l's
// input i. The output layer's pre-activations go to z_out.
template <int L>
__device__ __forceinline__ void forward(const float (&th)[kP], float (&a)[kActs],
                                        float (&z_out)[kOut]) {
  if constexpr (L < kNumLayers) {
    constexpr int din = dim(L);
    constexpr int dout = dim(L + 1);
    constexpr int w = w_off(L);
    constexpr int b = b_off(L);
    constexpr int ain = act_off(L);
    constexpr int aout = act_off(L + 1);
#pragma unroll
    for (int j = 0; j < dout; ++j) {
      float z = 0.0f;
#pragma unroll
      for (int i = 0; i < din; ++i) z += a[ain + i] * th[w + j * din + i];
      if constexpr (has_bias(L)) z += th[b + j];
      if constexpr (L == kNumLayers - 1) z_out[j] = z;
      if constexpr (L < kNumLayers - 1 || !kCrossEntropy) {
        a[aout + j] = sigmoid(z);
      } else {
        a[aout + j] = z;
      }
    }
    forward<L + 1>(th, a, z_out);
  }
}

// Backward pass of layers L..0 for one row: delta holds d log_lik / d z of
// layer L's outputs; accumulates the weight and bias gradients into g.
template <int L>
__device__ __forceinline__ void backward(const float (&th)[kP], const float (&a)[kActs],
                                         const float (&delta)[kMaxWidth], float (&g)[kP]) {
  constexpr int din = dim(L);
  constexpr int dout = dim(L + 1);
  constexpr int w = w_off(L);
  constexpr int b = b_off(L);
  constexpr int ain = act_off(L);
#pragma unroll
  for (int j = 0; j < dout; ++j) {
#pragma unroll
    for (int i = 0; i < din; ++i) g[w + j * din + i] += delta[j] * a[ain + i];
    if constexpr (has_bias(L)) g[b + j] += delta[j];
  }
  if constexpr (L > 0) {
    float next[kMaxWidth];
#pragma unroll
    for (int i = 0; i < din; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < dout; ++j) s += delta[j] * th[w + j * din + i];
      const float ai = a[ain + i];
      next[i] = s * ai * (1.0f - ai);
    }
    backward<L - 1>(th, a, next, g);
  }
}

// The data and prior constants of a block, in shared memory.
struct Data {
  const float* x;     // [n_rows, kIn]
  const float* y;     // [n_rows, kOut]
  const float* mask;  // [n_rows]
  const float* loc;   // [kP]
  const float* ivar;  // [kP]
};

// Floats of shared memory that stage_data fills.
__host__ __device__ constexpr size_t data_floats(int n_rows) {
  return static_cast<size_t>(n_rows) * (kIn + kOut + 1) + 2 * static_cast<size_t>(kP);
}

// Copy the data and prior constants into smem (data_floats(n_rows) floats)
// with all threads of the block, then wait for the block.
__device__ __forceinline__ Data stage_data(float* smem, const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           const float* __restrict__ mask,
                                           const float* __restrict__ loc,
                                           const float* __restrict__ ivar, int n_rows) {
  float* xs = smem;
  float* ys = xs + n_rows * kIn;
  float* ms = ys + n_rows * kOut;
  float* locs = ms + n_rows;
  float* ivs = locs + kP;
  for (int t = threadIdx.x; t < n_rows * kIn; t += blockDim.x) xs[t] = x[t];
  for (int t = threadIdx.x; t < n_rows * kOut; t += blockDim.x) ys[t] = y[t];
  for (int t = threadIdx.x; t < n_rows; t += blockDim.x) ms[t] = mask[t];
  for (int t = threadIdx.x; t < kP; t += blockDim.x) {
    locs[t] = loc[t];
    ivs[t] = ivar[t];
  }
  __syncthreads();
  return Data{xs, ys, ms, locs, ivs};
}

// Adds the untempered log-likelihood of staged row r (its mask applied) to
// log_lik; with kGrad the row's gradient is added to g, without it g is not
// touched and no backward pass runs. The row body of chain_log_lik and of the
// lane kernels (lane_eval.cuh), which split the rows over a chain's lanes.
template <bool kGrad>
__device__ __forceinline__ void row_log_lik(const float (&th)[kP], const Data& d, int r,
                                            float& log_lik, float (&g)[kP]) {
  float a[kActs];
  float z_out[kOut];
  float delta[kMaxWidth];
#pragma unroll
  for (int i = 0; i < kIn; ++i) a[i] = d.x[r * kIn + i];
  forward<0>(th, a, z_out);

  const float m = d.mask[r];
  const float* yr = d.y + r * kOut;
  if constexpr (kCrossEntropy) {
    float zmax = z_out[0];
#pragma unroll
    for (int j = 1; j < kOut; ++j) zmax = fmaxf(zmax, z_out[j]);
    // The k shifted exps serve both the log-sum-exp and the softmax.
    float e[kOut];
    float sumexp = 0.0f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      e[j] = expf(z_out[j] - zmax);
      sumexp += e[j];
    }
    const float lse = zmax + logf(sumexp);
    float picked = 0.0f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) picked += yr[j] * z_out[j];
    log_lik += (picked - lse) * m;
    if constexpr (kGrad) {
      const float inv_sumexp = 1.0f / sumexp;
#pragma unroll
      for (int j = 0; j < kOut; ++j) delta[j] = (yr[j] - e[j] * inv_sumexp) * m;
    }
  } else {
    constexpr int out = act_off(kNumLayers);
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const float z = z_out[j];
      const float softplus = fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)));
      log_lik += (yr[j] * z - softplus) * m;
      if constexpr (kGrad) delta[j] = (yr[j] - a[out + j]) * m;
    }
  }
  if constexpr (kGrad) backward<kNumLayers - 1>(th, a, delta, g);
}

// Untempered log-likelihood of one chain over the staged rows; with kGrad
// its gradient is added to g (which the caller zeroes), without it g is not
// touched and no backward pass runs.
template <bool kGrad>
__device__ __forceinline__ float chain_log_lik(const float (&th)[kP], const Data& d, int n_rows,
                                               float (&g)[kP]) {
  float log_lik = 0.0f;
  for (int r = 0; r < n_rows; ++r) row_log_lik<kGrad>(th, d, r, log_lik, g);
  return log_lik;
}

// Tempered log-posterior of one chain; with kGrad its gradient goes to g,
// without it g is not touched and no backward pass runs (the value-only
// body of the random-walk kernels).
template <bool kGrad>
__device__ __forceinline__ float chain_eval(const float (&th)[kP], const Data& d,
                                            float prior_const, float temperature, int n_rows,
                                            float (&g)[kP]) {
  if constexpr (kGrad) {
#pragma unroll
    for (int p = 0; p < kP; ++p) g[p] = 0.0f;
  }

  const float log_lik = chain_log_lik<kGrad>(th, d, n_rows, g);

  float log_prior = 0.0f;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const float diff = th[p] - d.loc[p];
    log_prior += -0.5f * diff * diff * d.ivar[p];
    if constexpr (kGrad) g[p] = temperature * (g[p] - diff * d.ivar[p]);
  }
  return temperature * (log_lik + (log_prior + prior_const));
}

// The split evaluation of the SMC mutation kernel, whose target lp + beta *
// ll tempers the likelihood only: returns (ll, lp), both untempered, the
// counterpart of make_vg(split=True); with kGrad, g = beta * d ll / d theta
// + d lp / d theta, the combined gradient of the target.
template <bool kGrad>
__device__ __forceinline__ float2 chain_eval_split(const float (&th)[kP], const Data& d,
                                                  float prior_const, float beta, int n_rows,
                                                  float (&g)[kP]) {
  if constexpr (kGrad) {
#pragma unroll
    for (int p = 0; p < kP; ++p) g[p] = 0.0f;
  }

  const float log_lik = chain_log_lik<kGrad>(th, d, n_rows, g);

  float log_prior = 0.0f;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const float diff = th[p] - d.loc[p];
    log_prior += -0.5f * diff * diff * d.ivar[p];
    if constexpr (kGrad) g[p] = -diff * d.ivar[p] + beta * g[p];
  }
  return make_float2(log_lik, log_prior + prior_const);
}

// Value and gradient (leapfrog, MALA, the fused kernel).
__device__ __forceinline__ float chain_vg(const float (&th)[kP], const Data& d,
                                          float prior_const, float temperature, int n_rows,
                                          float (&g)[kP]) {
  return chain_eval<true>(th, d, prior_const, temperature, n_rows, g);
}

// Value only (random-walk MH): the forward pass and the loss.
__device__ __forceinline__ float chain_v(const float (&th)[kP], const Data& d,
                                         float prior_const, float temperature, int n_rows) {
  float unused[kP];
  return chain_eval<false>(th, d, prior_const, temperature, n_rows, unused);
}

}  // namespace mlp_vg
