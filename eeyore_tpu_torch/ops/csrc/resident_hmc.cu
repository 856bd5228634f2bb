// The whole HMC loop for C chains of a sigmoid MLP in one kernel, on data
// staged in shared memory.
//
// Replaces the Pallas TPU kernel eeyore_tpu/ops/resident_hmc.py:256
// (make_resident_hmc); the plain PyTorch version is the CPU branch of
// eeyore_tpu_torch/ops/resident_hmc.py. Per chain and iteration t: draw the
// momenta (kernel_prng.cuh, key (seed, chain), counter (t, j)), run
// num_steps leapfrog steps of the tempered log-posterior (mlp_vg.cuh), accept
// with probability min(1, exp(H_cur - H_prop)), count post-burn-in accepts
// and record every record_thin-th post-burn-in state. With a tuner, dual
// averaging runs on the mean acceptance rate of the chain block during
// burn-in (the l-rule sets num_steps), and the last burn-in iteration
// freezes the averaged step, as resident_hmc.py:184-218 does. The loop is
// resident_loop.cuh::hmc_chain, shared with resident_hmc_dense.cu.
//
// Design.
// - One thread per chain; the tuning group is the CUDA block, one block per
//   chain_block chains (resident_loop.cuh::group_mean).
// - The leapfrog trip count is a per-thread loop. The TPU kernel masks the
//   lanes whose trajectory ended (resident_hmc.py:149-158); a thread stops on
//   its own and gets the same numbers.
// - The proposal theta, momentum and gradient live in registers (3P floats
//   beside the value-and-gradient body's own); the accepted theta and
//   gradient, touched once per iteration, live in shared memory at
//   [P][blockDim] (2 * 27 * 4 B * 256 = 55 KB for iris, dynamic shared
//   memory above 48 KB), beside the data rows.
// - Samples are written chain-minor, [kept, rows, C], so a warp's stores are
//   coalesced; the wrapper views them as [kept, C, P].
// - The launch counts the value-and-gradient evaluations it made (one per
//   chain at the start and one per leapfrog step) into a device counter,
//   from which chip_smoke.py computes the run's bound exactly.
//
// Bound. evaluations x the value and gradient (each bound by the
// special-function unit on iris, chip_smoke.py::vg_work), plus about 100
// integer operations per Threefry call and ceil(P/2) + 1 calls per
// iteration, plus kept x P x C x 4 bytes of samples. On iris the evaluations
// dominate by orders of magnitude, so the kernel is bound by operations; on
// XOR, whose evaluation is a few hundred operations, the sample bytes and the
// PRNG weigh more.

#include "resident_loop.cuh"

using namespace mlp_vg;
using resident_loop::kMaxThreads;

namespace {

__global__ void resident_hmc_kernel(const float* __restrict__ theta0,  // [P, C]
                                    const float* __restrict__ x, const float* __restrict__ y,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ loc,
                                    const float* __restrict__ ivar, const ResidentHMCParams pr,
                                    float* __restrict__ samples,      // [kept, rows, C]
                                    float* __restrict__ final_theta,  // [P, C]
                                    float* __restrict__ accepts,      // [C]
                                    unsigned long long* __restrict__ evaluations) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxThreads / 32];
  const Data d = stage_data(smem, x, y, mask, loc, ivar, pr.n_rows);
  float* acc_th = smem + data_floats(pr.n_rows);  // accepted theta, [P][bd]
  float* acc_g = acc_th + kP * blockDim.x;        // its gradient, [P][bd]
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  // Only an untuned run has a ragged last block; a tuned block is full, so
  // every thread reaches the block reductions.
  if (c >= pr.num_chains) return;
  const resident_loop::StagedEval ev{d, pr.prior_const, pr.temperature, pr.n_rows};
  resident_loop::hmc_chain(ev, pr, c, 1, theta0, samples, final_theta, accepts, evaluations,
                           acc_th, acc_g, red, nullptr);
}

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int resident_hmc_arch(int* out) {
  // num_params, input width, output width, cross-entropy flag, max threads per block
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  out[4] = kMaxThreads;
  return 0;
}

extern "C" int resident_hmc_resources(int* out) {
  // registers per thread, local-memory (spill) bytes per thread, and the
  // most threads a block of this build can launch with those registers
  return static_cast<int>(resident_loop::resources(resident_hmc_kernel, out));
}

extern "C" const char* resident_hmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_hmc_launch(const float* theta0, const float* x, const float* y,
                                   const float* mask, const float* loc, const float* ivar,
                                   const ResidentHMCParams* params, int threads,
                                   float* samples, float* final_theta, float* accepts,
                                   unsigned long long* evaluations, void* stream) {
  const ResidentHMCParams pr = *params;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem =
      sizeof(float) * (data_floats(pr.n_rows) + 2 * static_cast<size_t>(kP) * threads);
  const int blocks = (pr.num_chains + threads - 1) / threads;
  return static_cast<int>(resident_loop::launch(resident_hmc_kernel, blocks, threads, smem, 1,
                                                stream, theta0, x, y, mask, loc, ivar, pr,
                                                samples, final_theta, accepts, evaluations));
}
