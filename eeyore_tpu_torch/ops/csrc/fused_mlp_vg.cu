// Fused log-posterior and gradient of a sigmoid MLP for C chains at once.
//
// Replaces the Pallas TPU kernel eeyore_tpu/ops/fused_mlp.py::
// make_fused_log_target_vg (its math body is eeyore_tpu/ops/mlp_math.py::
// make_vg; the plain PyTorch version is eeyore_tpu_torch/ops/mlp_math.py::
// make_vg). For every chain c it computes
//   val[c]       = T * (log_lik(theta[:, c]) + log_prior(theta[:, c]))
//   grad[:, c]   = d val[c] / d theta[:, c]
// with BCE (sigmoid output) or softmax CE (logit output) and an IID Normal
// prior, by a forward pass, the output deltas and a hand-derived backward
// pass over the data rows.
//
// Design. One thread per chain. theta is [P, C], chains minor, so the
// threads of a warp read consecutive addresses. The architecture is fixed
// at compile time (FMV_* macros below), so every loop over units is
// unrolled and a chain's P parameters, P gradient accumulators and the
// activations of one row stay in registers. x, y, the row mask and the
// prior constants are staged once per block in shared memory; every thread
// of a warp then reads the same word, which is a broadcast.
//
// Bound. Per chain the kernel reads P floats and writes P + 1; the data is
// read once per block. For a row it does about 2*P + (sum of layer widths)
// multiply-adds of the forward and backward passes and one or two
// transcendental calls per unit, so for iris-sized data (150 rows) it does
// thousands of operations per byte it moves: it is bound by operations, and
// among them by the special-function unit's exp/log throughput. f32
// throughout, with expf, logf and log1pf and no fast-math intrinsics.

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

namespace {

constexpr int kNumLayers = FMV_NUM_LAYERS;
static_assert(kNumLayers >= 1 && kNumLayers <= 7, "1 to 7 layers");
constexpr bool kCrossEntropy = FMV_CE != 0;
constexpr int kThreads = 128;

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

__global__ void __launch_bounds__(kThreads)
fused_mlp_vg_kernel(const float* __restrict__ theta,  // [P, C]
                    const float* __restrict__ x,      // [n_rows, kIn]
                    const float* __restrict__ y,      // [n_rows, kOut]
                    const float* __restrict__ mask,   // [n_rows]
                    const float* __restrict__ loc,    // [P]
                    const float* __restrict__ ivar,   // [P]
                    float prior_const, float temperature, int n_rows, int C,
                    float* __restrict__ val,          // [C]
                    float* __restrict__ grad) {       // [P, C]
  extern __shared__ float smem[];
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

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;

  float th[kP];
  float g[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    th[p] = theta[static_cast<size_t>(p) * C + c];
    g[p] = 0.0f;
  }

  float log_lik = 0.0f;
  float a[kActs];
  float z_out[kOut];
  float delta[kMaxWidth];
  for (int r = 0; r < n_rows; ++r) {
#pragma unroll
    for (int i = 0; i < kIn; ++i) a[i] = xs[r * kIn + i];
    forward<0>(th, a, z_out);

    const float m = ms[r];
    const float* yr = ys + r * kOut;
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
      const float inv_sumexp = 1.0f / sumexp;
      float picked = 0.0f;
#pragma unroll
      for (int j = 0; j < kOut; ++j) picked += yr[j] * z_out[j];
      log_lik += (picked - lse) * m;
#pragma unroll
      for (int j = 0; j < kOut; ++j) delta[j] = (yr[j] - e[j] * inv_sumexp) * m;
    } else {
      constexpr int out = act_off(kNumLayers);
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float z = z_out[j];
        const float softplus = fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)));
        log_lik += (yr[j] * z - softplus) * m;
        delta[j] = (yr[j] - a[out + j]) * m;
      }
    }
    backward<kNumLayers - 1>(th, a, delta, g);
  }

  float log_prior = 0.0f;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const float diff = th[p] - locs[p];
    log_prior += -0.5f * diff * diff * ivs[p];
    grad[static_cast<size_t>(p) * C + c] = temperature * (g[p] - diff * ivs[p]);
  }
  val[c] = temperature * (log_lik + (log_prior + prior_const));
}

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int fused_mlp_vg_arch(int* out) {
  // num_params, input width, output width, cross-entropy flag
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  return 0;
}

extern "C" int fused_mlp_vg_resources(int* out) {
  // registers per thread, local-memory (spill) bytes per thread
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fused_mlp_vg_kernel);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

extern "C" const char* fused_mlp_vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int fused_mlp_vg_launch(const float* theta, const float* x, const float* y,
                                   const float* mask, const float* loc, const float* ivar,
                                   float prior_const, float temperature, int n_rows, int C,
                                   float* val, float* grad, void* stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_rows) * (kIn + kOut + 1) + 2 * static_cast<size_t>(kP));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_vg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((C + kThreads - 1) / kThreads);
  fused_mlp_vg_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      theta, x, y, mask, loc, ivar, prior_const, temperature, n_rows, C, val, grad);
  return static_cast<int>(cudaGetLastError());
}
