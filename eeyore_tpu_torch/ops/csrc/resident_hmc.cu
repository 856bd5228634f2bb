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
// lane_eval.cuh::hmc_chain, which resident_hmc_dense.cu runs too.
//
// Design.
// - HMC_LANES lanes of a warp per chain (lane_eval.cuh): lane l owns the
//   coordinates l, l + HMC_LANES, ... of the proposal, the momentum, the
//   gradient and the accepted theta and gradient, all in registers (14 each
//   on iris MLP(4,3,3) at 2 lanes, where one thread a chain held 27 of each
//   and kept the accepted pair in 55 KB of shared memory a block). Each
//   evaluation gathers theta through the chain's slot of P floats in shared
//   memory, runs the forward and backward pass of mlp_vg.cuh on the lane's
//   rows l, l + HMC_LANES, ... and reduce-scatters the gradient onto the
//   owners by shuffles; the kinetic energies and the log-likelihood reduce by
//   xor butterflies, so every lane holds the same bits and takes the same
//   accept, tuning and trip-count decisions. The 15 Threefry words of an
//   iteration (14 normal pairs and the accept uniform on iris) are spread
//   over the lanes, each computed once, and the normals reach their owners by
//   shuffles.
// - The tuning group is the chain_block consecutive chains, chain_block x
//   HMC_LANES threads: at up to 4 lanes one CUDA block of up to 1024 threads
//   (a group of 256 chains), so the group mean is a block reduction with no
//   cluster barrier; at 8 lanes a thread-block cluster of blocks of 256
//   (lane_eval.cuh::group_mean counts each chain once). The launch bounds
//   (HMC_MIN_BLOCKS blocks of that size an SM) cap the registers: the
//   kernel is bound by latency, so resident warps pay, but the evaluator's
//   gathered theta and gradient partials (54 floats a lane) spill under a
//   cap of 64 registers. On config 3 (groups of 256 chains, 128 groups)
//   2 lanes at 128 registers, 16 warps an SM, ran fastest, ahead of 4 lanes
//   at 64 (32 warps, 320 B of spills) and 8 lanes in clusters
//   (ops/resident_hmc.py::HMC_LANES, scripts/lane_sweep.py, PERF.md).
// - HMC_LANES = 1 is one thread a chain: the accepted theta and gradient in
//   shared memory at [P][blockDim] beside the data rows, the draws where they
//   are used, no launch bounds; ops/resident_hmc.py::chain_lanes picks it for
//   data of few rows (staged XOR), where a lane would get no rows to split,
//   and for a tuning group larger than a cluster of lane blocks holds. Its
//   tuning group is a block or, larger than the registers let a block be, a
//   cluster (resident_loop.cuh::group_mean, as resident_hmc_dense.cu runs
//   it): staged XOR at 96 registers takes JAX's group of 4096 chains as a
//   cluster of 8 blocks of 512.
// - The leapfrog trip count is a per-chain loop. The TPU kernel masks the
//   lanes whose trajectory ended (resident_hmc.py:149-158); a chain stops on
//   its own and gets the same numbers.
// - Samples are written chain-minor, [kept, rows, C]: on lanes through a
//   shared-memory tile of the block's chains, one record a flush; the wrapper
//   views them as [kept, C, P].
// - The launch counts the value-and-gradient evaluations it made (one per
//   chain at the start and one per leapfrog step, once a chain) into a device
//   counter, from which chip_smoke.py computes the run's bound exactly.
//
// Bound. evaluations x the value and gradient (each bound by the
// special-function unit on iris, chip_smoke.py::vg_work), plus about 100
// integer operations per Threefry call and ceil(P/2) + 1 calls per
// iteration, plus kept x P x C x 4 bytes of samples. On iris the evaluations
// dominate by orders of magnitude, so the kernel is bound by operations; on
// XOR, whose evaluation is a few hundred operations, the sample bytes and the
// PRNG weigh more.

#include "lane_eval.cuh"

#if !defined(HMC_LANES) || !defined(HMC_MIN_BLOCKS)
#error "HMC_LANES (lanes a chain) and HMC_MIN_BLOCKS must be defined"
#endif

using namespace mlp_vg;
using resident_loop::kMaxThreads;

namespace {

constexpr int kLanes = HMC_LANES;
using HmcLanes = lane_eval::Lanes<kLanes>;
// Threads a block may have: one thread a chain, kMaxThreads; on up to 4
// lanes a tuning group of 256 chains; on 8 lanes 256 (a group of 256 chains
// is a cluster of 8 such blocks). The launch bounds keep HMC_MIN_BLOCKS such
// blocks on an SM.
constexpr int kBlockThreads = kLanes == 1 ? kMaxThreads : (kLanes <= 4 ? 256 * kLanes : 256);

#if HMC_LANES == 1
#define HMC_LAUNCH_BOUNDS
#else
#define HMC_LAUNCH_BOUNDS __launch_bounds__(kBlockThreads, HMC_MIN_BLOCKS)
#endif

__global__ void HMC_LAUNCH_BOUNDS
    resident_hmc_kernel(const float* __restrict__ theta0,  // [P, C]
                        const float* __restrict__ x, const float* __restrict__ y,
                        const float* __restrict__ mask,
                        const float* __restrict__ loc,
                        const float* __restrict__ ivar, const ResidentHMCParams pr,
                        float* __restrict__ samples,      // [kept, rows, C]
                        float* __restrict__ final_theta,  // [P, C]
                        float* __restrict__ accepts,      // [C]
                        unsigned long long* __restrict__ evaluations,
                        int cluster_blocks) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxThreads / 32];
  __shared__ float partial[2];
  const Data d = stage_data(smem, x, y, mask, loc, ivar, pr.n_rows);
  float* buf = smem + data_floats(pr.n_rows);
#if HMC_LANES == 1  // buf: the accepted theta and its gradient, [P][bd] each
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  // Only an untuned run, which takes no cluster, has a ragged last block; a
  // tuned block is full, so every thread reaches the group reductions.
  if (c >= pr.num_chains) return;
  const resident_loop::StagedEval ev{d, pr.prior_const, pr.temperature, pr.n_rows};
  lane_eval::hmc_chain(ev, HmcLanes{}, pr, c, cluster_blocks, theta0, samples, final_theta,
                       accepts, evaluations, buf, red, partial);
#else  // buf: a theta slot [P] per chain, then the record tile
  // the launch covers the chains exactly: every thread reaches every barrier
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const HmcLanes ln;
  const lane_eval::LaneStagedEval<HmcLanes> ev{d, pr.prior_const, pr.temperature, pr.n_rows, ln,
                                               buf + kP * (threadIdx.x / kLanes)};
  buf += static_cast<size_t>(kP) * (blockDim.x / kLanes);
  lane_eval::hmc_chain(ev, ln, pr, c, cluster_blocks, theta0, samples, final_theta, accepts,
                       evaluations, buf, red, partial);
#endif
  // no block of a cluster leaves while another may read its partial sum
  if (cluster_blocks > 1) cooperative_groups::this_cluster().sync();
}

size_t smem_bytes(int threads, int n_rows) {
  const size_t chain_floats =
      kLanes == 1 ? 2 * static_cast<size_t>(kP) * threads
                  : static_cast<size_t>(kP) * (threads / kLanes) +
                        lane_eval::walk_tile_floats(kLanes, threads);
  return sizeof(float) * (data_floats(n_rows) + chain_floats);
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

extern "C" int resident_hmc_lanes() { return kLanes; }

extern "C" int resident_hmc_resources(int* out) {
  // registers per thread, local-memory (spill) bytes per thread, and the
  // most threads a block of this build can launch with those registers
  return static_cast<int>(resident_loop::resources(resident_hmc_kernel, out));
}

extern "C" int resident_hmc_max_clusters(int threads, int cluster_blocks, int n_rows, int* out) {
  return static_cast<int>(resident_loop::max_active_clusters(
      resident_hmc_kernel, threads, cluster_blocks, smem_bytes(threads, n_rows), out));
}

// Blocks of threads threads an SM holds at once, for n_rows staged rows.
extern "C" int resident_hmc_max_blocks(int threads, int n_rows, int* out) {
  return static_cast<int>(resident_loop::max_active_blocks(
      resident_hmc_kernel, threads, smem_bytes(threads, n_rows), out));
}

extern "C" const char* resident_hmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_hmc_launch(const float* theta0, const float* x, const float* y,
                                   const float* mask, const float* loc, const float* ivar,
                                   const ResidentHMCParams* params, int threads,
                                   int cluster_blocks, float* samples, float* final_theta,
                                   float* accepts, unsigned long long* evaluations,
                                   void* stream) {
  const ResidentHMCParams pr = *params;
  const long long lanes = static_cast<long long>(pr.num_chains) * kLanes;
  const long long group = static_cast<long long>(pr.chain_block) * kLanes;  // threads a group
  if (threads < 32 || threads > kBlockThreads || threads % 32 != 0 || cluster_blocks < 1 ||
      cluster_blocks > resident_loop::kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // a tuning group is the block or the cluster, and the clusters cover the chains
  const bool grouped = pr.tuned || cluster_blocks > 1;
  if ((kLanes > 1 && lanes % threads != 0) ||
      (grouped && (cluster_blocks * threads != group || pr.chain_block < 1 ||
                   pr.num_chains % pr.chain_block != 0))) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int blocks =
      static_cast<int>(kLanes == 1 ? (pr.num_chains + threads - 1) / threads : lanes / threads);
  return static_cast<int>(resident_loop::launch(
      resident_hmc_kernel, blocks, threads, smem_bytes(threads, pr.n_rows), cluster_blocks,
      stream, theta0, x, y, mask, loc, ivar, pr, samples, final_theta, accepts, evaluations,
      cluster_blocks));
}
