// The SMC mutation pass of N particles of a sigmoid MLP in one kernel, on
// data staged in shared memory.
//
// Replaces the Pallas TPU kernel of
// eeyore_tpu/ops/resident_smc.py::make_resident_smc_mutation (:195, the
// pl.pallas_call at :329); the plain PyTorch version is
// eeyore_tpu_torch/ops/resident_smc.py::_run_mutation_plain. Each particle
// runs num_steps MH or MALA moves (the template flag kMALA) at the tempered
// target lp + beta * ll, the likelihood-tempered path of tempered SMC, and
// the kernel writes the final theta [P, N], the accepted state's untempered
// log-likelihood pot [N] (the next stage's reweighting potential, so the
// runner never evaluates it again) and the accept counts [N]. beta is a
// launch argument, as the TPU kernel's SMEM scalar is, so one build per
// architecture serves every stage of every anneal. The step's derived
// constants (sqrt(step), step / 2, 0.5 / step) are rounded from float64 to
// float32 on the host, as JAX divides the Python float.
//
// Stream: the walk stream of kernel_prng.cuh, key (stage seed, particle),
// counter (mutation step, j): for j < ceil(P/2) the Box-Muller pairs of the
// proposal normals, j = ceil(P/2) the accept uniform. The runner seeds stage
// k with seed + 7919 k (mod 2^32).
//
// Design. One thread per particle (resident_loop.cuh::smc_mutation_chain on
// the split evaluation mlp_vg.cuh::chain_eval_split); the data rows and the
// prior staged once per block in shared memory; the accepted theta (and,
// for MALA, the combined gradient beta * gll + glp) in shared memory at
// [P][blockDim], the proposal in registers. Particles share nothing, so a
// block is any multiple of 32 threads: 128, so that the 16384 particles of
// BASELINE.md config 5 make 128 blocks on the 132 SMs.
//
// Bound. Per particle 1 + num_steps evaluations (value and gradient for
// MALA, value only for MH), per step ceil(P/2) + 1 Threefry calls and
// ceil(P/2) Box-Muller pairs; bytes: theta read once, the data once, final,
// pot and counts written once. The evaluations dominate: bound by
// operations (the special-function unit on iris).

#include "resident_loop.cuh"

using namespace mlp_vg;
using resident_loop::kMaxThreads;

namespace {

template <bool kMALA>
__global__ void resident_smc_kernel(const float* __restrict__ theta0,  // [P, N]
                                    const float* __restrict__ x, const float* __restrict__ y,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ loc,
                                    const float* __restrict__ ivar, const ResidentSMCParams pr,
                                    float* __restrict__ final_theta,  // [P, N]
                                    float* __restrict__ pot,          // [N]
                                    float* __restrict__ accepts) {    // [N]
  extern __shared__ float smem[];
  const Data d = stage_data(smem, x, y, mask, loc, ivar, pr.n_rows);
  float* acc_th = smem + data_floats(pr.n_rows);  // accepted theta, [P][bd]
  float* acc_g = acc_th + kP * blockDim.x;        // its combined gradient (MALA), [P][bd]
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= pr.num_particles) return;  // no block barrier follows
  const resident_loop::SplitEval ev{d, pr.prior_const, pr.beta, pr.n_rows};
  resident_loop::smc_mutation_chain<resident_loop::SplitEval, kMALA>(ev, pr, c, theta0,
                                                                     final_theta, pot, accepts,
                                                                     acc_th, acc_g);
}

size_t smem_bytes(bool mala, int n_rows, int threads) {
  return sizeof(float) *
         (data_floats(n_rows) + (mala ? 2 : 1) * static_cast<size_t>(kP) * threads);
}

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int resident_smc_arch(int* out) {
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  out[4] = kMaxThreads;
  return 0;
}

// move: 0 MH, 1 MALA.
extern "C" int resident_smc_resources(int move, int* out) {
  return static_cast<int>(move == 1 ? resident_loop::resources(resident_smc_kernel<true>, out)
                                    : resident_loop::resources(resident_smc_kernel<false>, out));
}

extern "C" const char* resident_smc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_smc_launch(int mala, const float* theta0, const float* x, const float* y,
                                   const float* mask, const float* loc, const float* ivar,
                                   const ResidentSMCParams* params, int threads,
                                   float* final_theta, float* pot, float* accepts, void* stream) {
  const ResidentSMCParams pr = *params;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || pr.num_particles < 1 ||
      pr.num_steps < 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = smem_bytes(mala != 0, pr.n_rows, threads);
  const int blocks = (pr.num_particles + threads - 1) / threads;
  const cudaError_t err =
      mala ? resident_loop::launch(resident_smc_kernel<true>, blocks, threads, smem, 1, stream,
                                   theta0, x, y, mask, loc, ivar, pr, final_theta, pot, accepts)
           : resident_loop::launch(resident_smc_kernel<false>, blocks, threads, smem, 1, stream,
                                   theta0, x, y, mask, loc, ivar, pr, final_theta, pot, accepts);
  return static_cast<int>(err);
}
