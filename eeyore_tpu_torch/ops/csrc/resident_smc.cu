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
// Design. SMC_LANES lanes of a warp a particle (lane_eval.cuh::smc_chain on
// LaneSplitEval, the loop written once over the lanes, walk_chain's draws and
// accept algebra at the likelihood-tempered target): lane l evaluates the
// staged rows l, l + SMC_LANES, ... (mlp_vg.cuh::row_log_lik), the
// log-likelihood and the prior reduce by xor butterflies and the gradient is
// reduce-scattered onto the lanes that own its coordinates, so every lane
// takes the same accept decision; the accepted theta and gradient live in
// registers, spread over the lanes, and the step's Threefry words are spread
// too. The data rows and the prior are staged once per block in shared
// memory, beside a theta slot per particle. Particles share nothing, so a
// block is 256 threads, of which SMC_MIN_BLOCKS must fit an SM (the launch
// bounds that cap the registers: the pass is bound by latency, and one
// thread a particle walked iris's 150 rows serially with 4 warps an SM),
// and the launch covers the particles exactly. SMC_LANES = 1 is one thread a
// particle (ops/resident_smc.py::smc_lanes takes it on fewer than
// resident_hmc.LANE_MIN_ROWS padded rows, XOR's 8): smc_chain on
// resident_loop.cuh::SplitEval, the accepted theta (and the combined
// gradient beta * gll + glp, MALA) in shared memory at [P][blockDim], blocks
// of SMC_BLOCK threads, no launch bounds.
//
// Bound. Per particle 1 + num_steps evaluations (value and gradient for
// MALA, value only for MH), per step ceil(P/2) + 1 Threefry calls and
// ceil(P/2) Box-Muller pairs; bytes: theta read once, the data once, final,
// pot and counts written once. The evaluations dominate: bound by
// operations (the special-function unit on iris).

#include "lane_eval.cuh"

#if !defined(SMC_LANES) || !defined(SMC_MIN_BLOCKS)
#error "SMC_LANES (lanes a particle) and SMC_MIN_BLOCKS must be defined"
#endif

using namespace mlp_vg;
using resident_loop::kMaxThreads;

namespace {

constexpr int kSmcLanes = SMC_LANES;
using SmcLanes = lane_eval::Lanes<kSmcLanes>;
// Threads a block may have: one thread a particle kMaxThreads, on lanes 256.
constexpr int kSmcThreads = kSmcLanes == 1 ? kMaxThreads : 256;

#if SMC_LANES == 1
#define SMC_LAUNCH_BOUNDS
#else
#define SMC_LAUNCH_BOUNDS __launch_bounds__(kSmcThreads, SMC_MIN_BLOCKS)
#endif

template <bool kMALA>
__global__ void SMC_LAUNCH_BOUNDS
    resident_smc_kernel(const float* __restrict__ theta0,  // [P, N]
                        const float* __restrict__ x, const float* __restrict__ y,
                        const float* __restrict__ mask, const float* __restrict__ loc,
                        const float* __restrict__ ivar, const ResidentSMCParams pr,
                        float* __restrict__ final_theta,  // [P, N]
                        float* __restrict__ pot,          // [N]
                        float* __restrict__ accepts) {    // [N]
  extern __shared__ float smem[];
  const Data d = stage_data(smem, x, y, mask, loc, ivar, pr.n_rows);
  float* buf = smem + data_floats(pr.n_rows);
#if SMC_LANES == 1  // buf: the accepted theta and its combined gradient (MALA), [P][bd] each
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= pr.num_particles) return;  // no block barrier follows
  const resident_loop::SplitEval ev{d, pr.prior_const, pr.beta, pr.n_rows};
  lane_eval::smc_chain<kMALA>(ev, SmcLanes{}, pr, c, theta0, final_theta, pot, accepts, buf);
#else  // buf: a theta slot [P] per particle
  // the launch covers the particles exactly
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / kSmcLanes;
  const SmcLanes ln;
  const lane_eval::LaneSplitEval<SmcLanes> ev{d, pr.prior_const, pr.beta, pr.n_rows, ln,
                                              buf + kP * (threadIdx.x / kSmcLanes)};
  lane_eval::smc_chain<kMALA>(ev, ln, pr, c, theta0, final_theta, pot, accepts, nullptr);
#endif
}

size_t smem_bytes(bool mala, int n_rows, int threads) {
  const size_t chain_floats = kSmcLanes == 1
                                  ? (mala ? 2 : 1) * static_cast<size_t>(kP) * threads
                                  : static_cast<size_t>(kP) * (threads / kSmcLanes);
  return sizeof(float) * (data_floats(n_rows) + chain_floats);
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

// Lanes a particle.
extern "C" int resident_smc_lanes() { return kSmcLanes; }

// move: 0 MH, 1 MALA.
extern "C" int resident_smc_resources(int move, int* out) {
  return static_cast<int>(move == 1 ? resident_loop::resources(resident_smc_kernel<true>, out)
                                    : resident_loop::resources(resident_smc_kernel<false>, out));
}

// Blocks of threads threads of the MH (move 0) or MALA (1) pass an SM holds
// at once, for n_rows staged rows.
extern "C" int resident_smc_max_blocks(int move, int threads, int n_rows, int* out) {
  const size_t smem = smem_bytes(move == 1, n_rows, threads);
  return static_cast<int>(
      move == 1 ? resident_loop::max_active_blocks(resident_smc_kernel<true>, threads, smem, out)
                : resident_loop::max_active_blocks(resident_smc_kernel<false>, threads, smem,
                                                   out));
}

extern "C" const char* resident_smc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_smc_launch(int mala, const float* theta0, const float* x, const float* y,
                                   const float* mask, const float* loc, const float* ivar,
                                   const ResidentSMCParams* params, int threads,
                                   float* final_theta, float* pot, float* accepts, void* stream) {
  const ResidentSMCParams pr = *params;
  const long long lanes = static_cast<long long>(pr.num_particles) * kSmcLanes;
  if (threads < 32 || threads > kSmcThreads || threads % 32 != 0 || pr.num_particles < 1 ||
      pr.num_steps < 0 || (kSmcLanes > 1 && lanes % threads != 0)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = smem_bytes(mala != 0, pr.n_rows, threads);
  const int blocks = static_cast<int>((lanes + threads - 1) / threads);
  const cudaError_t err =
      mala ? resident_loop::launch(resident_smc_kernel<true>, blocks, threads, smem, 1, stream,
                                   theta0, x, y, mask, loc, ivar, pr, final_theta, pot, accepts)
           : resident_loop::launch(resident_smc_kernel<false>, blocks, threads, smem, 1, stream,
                                   theta0, x, y, mask, loc, ivar, pr, final_theta, pot, accepts);
  return static_cast<int>(err);
}
