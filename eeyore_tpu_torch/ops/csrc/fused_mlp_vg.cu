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
// at compile time (FMV_* macros in mlp_vg.cuh, which holds the per-chain
// body shared with resident_hmc.cu), so every loop over units is unrolled
// and a chain's P parameters, P gradient accumulators and the activations
// of one row stay in registers. x, y, the row mask and the prior constants
// are staged once per block in shared memory; every thread of a warp then
// reads the same word, which is a broadcast.
//
// Bound. Per chain the kernel reads P floats and writes P + 1; the data is
// read once per block. For a row it does about 2*P + (sum of layer widths)
// multiply-adds of the forward and backward passes and one or two
// transcendental calls per unit, so for iris-sized data (150 rows) it does
// thousands of operations per byte it moves: it is bound by operations, and
// among them by the special-function unit's exp/log throughput. f32
// throughout, with expf, logf and log1pf and no fast-math intrinsics.

#include "mlp_vg.cuh"

using namespace mlp_vg;

namespace {

constexpr int kThreads = 128;

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
  const Data d = stage_data(smem, x, y, mask, loc, ivar, n_rows);

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;

  float th[kP];
  float g[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) th[p] = theta[static_cast<size_t>(p) * C + c];
  const float v = chain_vg(th, d, prior_const, temperature, n_rows, g);
#pragma unroll
  for (int p = 0; p < kP; ++p) grad[static_cast<size_t>(p) * C + c] = g[p];
  val[c] = v;
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
  const size_t smem = sizeof(float) * data_floats(n_rows);
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
