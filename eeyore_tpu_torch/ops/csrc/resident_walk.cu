// The whole random-walk MH or MALA loop for C chains of a sigmoid MLP in one
// kernel, on data staged in shared memory.
//
// Replaces the MH and MALA moves of the Pallas TPU kernel
// eeyore_tpu/ops/resident_walk.py:166 (_make_resident, behind
// make_resident_mh :251 and make_resident_mala :212); the plain PyTorch
// version is the CPU branch of eeyore_tpu_torch/ops/resident_walk.py. The
// loop is resident_loop.cuh::walk_chain, shared with resident_walk_dense.cu;
// one library holds both moves for one architecture (move 0: MH, on the
// value-only body, no backward pass; move 1: MALA, on the value and
// gradient). These kernels have no tuner, as the TPU's have none: chains
// share nothing, and a block is any 32-multiple of threads.
//
// Design. One thread per chain; the accepted theta (and gradient, MALA) in
// shared memory at [P][blockDim] beside the staged data rows; the proposal
// (and its gradient) in registers; samples chain-minor [kept, rows, C].
//
// Bound. One evaluation per chain and iteration (value only for MH), plus
// ceil(P/2) + 1 Threefry calls and ceil(P/2) Box-Muller pairs, plus kept x
// rows x C x 4 bytes of samples. On iris the evaluation dominates: bound by
// operations (the special-function unit).

#include "resident_loop.cuh"

using namespace mlp_vg;
using resident_loop::kMaxThreads;

namespace {

template <bool kMALA>
__global__ void resident_walk_kernel(const float* __restrict__ theta0,  // [P, C]
                                     const float* __restrict__ x, const float* __restrict__ y,
                                     const float* __restrict__ mask,
                                     const float* __restrict__ loc,
                                     const float* __restrict__ ivar, const ResidentWalkParams pr,
                                     float* __restrict__ samples,      // [kept, rows, C]
                                     float* __restrict__ final_theta,  // [P, C]
                                     float* __restrict__ accepts) {    // [C]
  extern __shared__ float smem[];
  const Data d = stage_data(smem, x, y, mask, loc, ivar, pr.n_rows);
  float* acc_th = smem + data_floats(pr.n_rows);  // accepted theta, [P][bd]
  float* acc_g = acc_th + kP * blockDim.x;        // its gradient (MALA), [P][bd]
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= pr.num_chains) return;  // untuned: no block reduction follows
  const resident_loop::StagedEval ev{d, pr.prior_const, pr.temperature, pr.n_rows};
  resident_loop::walk_chain<resident_loop::StagedEval, kMALA>(
      ev, pr, c, 1, theta0, samples, final_theta, accepts, acc_th, acc_g, nullptr, nullptr);
}

size_t smem_bytes(int move, int n_rows, int threads) {
  return sizeof(float) *
         (data_floats(n_rows) + (move == 1 ? 2 : 1) * static_cast<size_t>(kP) * threads);
}

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int resident_walk_arch(int* out) {
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  out[4] = kMaxThreads;
  return 0;
}

extern "C" int resident_walk_resources(int move, int* out) {
  return static_cast<int>(move == 1 ? resident_loop::resources(resident_walk_kernel<true>, out)
                                    : resident_loop::resources(resident_walk_kernel<false>, out));
}

extern "C" const char* resident_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_walk_launch(int move, const float* theta0, const float* x,
                                    const float* y, const float* mask, const float* loc,
                                    const float* ivar, const ResidentWalkParams* params,
                                    int threads, float* samples, float* final_theta,
                                    float* accepts, void* stream) {
  const ResidentWalkParams pr = *params;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || pr.tuned ||
      (move != 0 && move != 1)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = smem_bytes(move, pr.n_rows, threads);
  const int blocks = (pr.num_chains + threads - 1) / threads;
  const cudaError_t err =
      move == 1 ? resident_loop::launch(resident_walk_kernel<true>, blocks, threads, smem, 1,
                                        stream, theta0, x, y, mask, loc, ivar, pr, samples,
                                        final_theta, accepts)
                : resident_loop::launch(resident_walk_kernel<false>, blocks, threads, smem, 1,
                                        stream, theta0, x, y, mask, loc, ivar, pr, samples,
                                        final_theta, accepts);
  return static_cast<int>(err);
}
