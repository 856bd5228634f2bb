// The whole fixed-budget NUTS loop for C chains of a sigmoid MLP in one
// kernel, on data staged in shared memory.
//
// Replaces the Pallas TPU kernel eeyore_tpu/ops/resident_nuts.py:371
// (make_resident_nuts); the plain PyTorch version is
// eeyore_tpu_torch/ops/resident_nuts.py::_run_nuts_plain. Per chain and
// iteration: the momenta and the tree's uniforms from the NUTS stream
// (kernel_prng.cuh, key (seed, chain), counter (t, j)), then the 2^D - 1
// leapfrog steps of a depth-D tree of the tempered log-posterior (mlp_vg.cuh)
// with JAX's masked fixed-budget algebra, the post-burn-in sums of
// accept_stat and of the divergence flag, and every record_thin-th
// post-burn-in state. With a tuner, the step is dual-averaged on the mean
// accept_stat of the tuning group during burn-in, as resident_nuts.py:290-307
// does. The loop is lane_eval.cuh::nuts_chain, which resident_nuts_dense.cu
// runs too.
//
// Design.
// - NUTS_LANES lanes of a warp per chain (lane_eval.cuh): every vector of the
//   tree state spread over the lanes (lane l owns the coordinates l, l +
//   NUTS_LANES, ...), each evaluation gathering theta through the chain's
//   slot in shared memory, running the forward and backward pass on the
//   lane's rows and reduce-scattering the gradient by shuffles; the dot
//   products and the log-likelihood reduce by xor butterflies, so every lane
//   holds the same bits and takes the same branches. The TPU kernel unrolls
//   the doublings and the leaves and keeps the checkpoint stack in static
//   slots; here both are loops over the compile-time depth (NUTS_DEPTH), a
//   chain takes its own branches (direction, proposals, merges) where the TPU
//   masks lanes, and the stack, indexed by popcount(n) at run time, is
//   selected slot by slot, so it stays in registers. On iris (P = 27) at 8
//   lanes a lane holds 68 floats of tree state, where one thread a chain held
//   459 and spilled (the build phase of chip_smoke.py reports registers and
//   local bytes).
// - The tuning group is the chain_block consecutive chains, chain_block x
//   NUTS_LANES threads: one CUDA block, or a thread-block cluster of up to 16
//   blocks (lane_eval.cuh::group_mean counts each chain once). A block has at
//   most 16 NUTS_LANES threads (the launch bounds that keep NUTS_MIN_BLOCKS
//   blocks an SM), so a cluster holds 256 chains. JAX's tuning groups of up
//   to 4096 chains on small data need a build with NUTS_LANES = 1: one thread
//   a chain, the tree state whole in the thread, the evaluation
//   resident_loop.cuh::StagedEval, no launch bounds, so a cluster of 16
//   blocks of 256 threads at up to 255 registers holds 4096 chains
//   (ops/resident_nuts.py::chain_lanes picks it).
// - Shared memory: the data rows and prior constants, the metric (M^-1 and
//   1/sqrt(M^-1), ones for none), then on lanes a theta slot [P] per chain
//   and the record tile [rows][chains of the block], on one thread the
//   accepted theta [P][threads].
// - Samples are written chain-minor, [kept, rows, C], through the tile on
//   lanes.
//
// Bound. Every chain evaluates the value and gradient 1 + num_iters (2^D - 1)
// times (each bound by the special-function unit on iris,
// chip_smoke.py::vg_work), plus per iteration ceil(P/2) Box-Muller pairs and
// 2^D - 1 + 2D more Threefry words, plus kept x P x C x 4 bytes of samples.
// On iris the evaluations dominate, so the kernel is bound by operations.

#include "lane_eval.cuh"

#if !defined(NUTS_DEPTH) || !defined(NUTS_LANES) || !defined(NUTS_MIN_BLOCKS)
#error "NUTS_DEPTH (the tree depth), NUTS_LANES (lanes a chain) and NUTS_MIN_BLOCKS must be defined"
#endif

using namespace mlp_vg;
using resident_loop::kMaxThreads;

namespace {

constexpr int kDepth = NUTS_DEPTH;
constexpr int kLanes = NUTS_LANES;
using NutsLanes = lane_eval::Lanes<kLanes>;
// Threads a block may have on lanes: a tuning group of JAX's 256 chains on
// iris (256 kLanes threads) must fit a cluster of kMaxCluster blocks, so the
// compiler keeps the registers to what NUTS_MIN_BLOCKS blocks of 16 kLanes
// threads on one SM allow (ops/resident_nuts.py::NUTS_MIN_BLOCKS). One
// thread a chain takes kMaxThreads and no bound.
constexpr int kBlockThreads = kLanes == 1 ? kMaxThreads : 16 * kLanes;

#if NUTS_LANES == 1
#define NUTS_LAUNCH_BOUNDS
#else
#define NUTS_LAUNCH_BOUNDS __launch_bounds__(kBlockThreads, NUTS_MIN_BLOCKS)
#endif

__global__ void NUTS_LAUNCH_BOUNDS
    resident_nuts_kernel(const float* __restrict__ theta0,  // [P, C]
                         const float* __restrict__ x, const float* __restrict__ y,
                         const float* __restrict__ mask,
                         const float* __restrict__ loc,
                         const float* __restrict__ ivar,
                         const float* __restrict__ inv_mass,  // [P]
                         const float* __restrict__ mom_scale,  // [P]
                         const ResidentHMCParams pr,
                         float* __restrict__ samples,      // [kept, rows, C]
                         float* __restrict__ final_theta,  // [P, C]
                         float* __restrict__ accepts,      // [C]
                         float* __restrict__ divergences,  // [C]
                         float* __restrict__ steps,        // [C]
                         int cluster_blocks) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxThreads / 32];
  __shared__ float partial[2];
  float* metric = smem + data_floats(pr.n_rows);  // M^-1 [P], then 1/sqrt(M^-1) [P]
  for (int i = threadIdx.x; i < kP; i += blockDim.x) {
    metric[i] = inv_mass[i];
    metric[kP + i] = mom_scale[i];
  }
  const Data d = stage_data(smem, x, y, mask, loc, ivar, pr.n_rows);  // waits for the block
  float* buf = metric + 2 * kP;  // what follows the metric: per layout below
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const NutsLanes ln;
#if NUTS_LANES == 1  // buf: the accepted theta [P][threads]
  const resident_loop::StagedEval ev{d, pr.prior_const, pr.temperature, pr.n_rows};
  const resident_loop::ArrayMetric mt{metric, metric + kP};
#else
  const lane_eval::LaneStagedEval<NutsLanes> ev{d, pr.prior_const, pr.temperature, pr.n_rows, ln,
                                                buf + kP * (threadIdx.x / kLanes)};
  const lane_eval::LaneMetric<NutsLanes> mt(ln, metric, metric + kP);
  buf += static_cast<size_t>(kP) * (blockDim.x / kLanes);  // the record tile
#endif
  lane_eval::nuts_chain<kDepth>(ev, ln, mt, pr, c, cluster_blocks, theta0, samples, final_theta,
                                accepts, divergences, steps, buf, red, partial);
  // no block of a cluster leaves while another may read its partial sum
  if (cluster_blocks > 1) cooperative_groups::this_cluster().sync();
}

size_t smem_bytes(int threads, int n_rows) {
  const size_t chain_floats =
      kLanes == 1 ? static_cast<size_t>(kP) * threads
                  : static_cast<size_t>(kP) * (threads / kLanes) +
                        lane_eval::tile_floats(kLanes, threads);
  return sizeof(float) * (data_floats(n_rows) + 2 * static_cast<size_t>(kP) + chain_floats);
}

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int resident_nuts_arch(int* out) {
  // num_params, input width, output width, cross-entropy flag, max threads per block
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  out[4] = kMaxThreads;
  return 0;
}

extern "C" int resident_nuts_lanes() { return kLanes; }

extern "C" int resident_nuts_resources(int* out) {
  return static_cast<int>(resident_loop::resources(resident_nuts_kernel, out));
}

extern "C" int resident_nuts_max_clusters(int threads, int cluster_blocks, int n_rows, int* out) {
  return static_cast<int>(resident_loop::max_active_clusters(
      resident_nuts_kernel, threads, cluster_blocks, smem_bytes(threads, n_rows), out));
}

// Blocks of threads threads an SM holds at once, for n_rows staged rows.
extern "C" int resident_nuts_max_blocks(int threads, int n_rows, int* out) {
  return static_cast<int>(resident_loop::max_active_blocks(
      resident_nuts_kernel, threads, smem_bytes(threads, n_rows), out));
}

extern "C" const char* resident_nuts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_nuts_launch(const float* theta0, const float* x, const float* y,
                                    const float* mask, const float* loc, const float* ivar,
                                    const float* inv_mass, const float* mom_scale,
                                    const ResidentHMCParams* params, int threads,
                                    int cluster_blocks, float* samples, float* final_theta,
                                    float* accepts, float* divergences, float* steps,
                                    void* stream) {
  const ResidentHMCParams pr = *params;
  const long long group = static_cast<long long>(pr.chain_block) * kLanes;  // threads a group
  if (threads < 32 || threads > kBlockThreads || threads % 32 != 0 || group % threads != 0 ||
      pr.num_chains % pr.chain_block != 0 || cluster_blocks < 1 ||
      cluster_blocks > resident_loop::kMaxCluster ||
      ((pr.tuned || cluster_blocks > 1) && cluster_blocks * threads != group)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long blocks = static_cast<long long>(pr.num_chains) * kLanes / threads;
  return static_cast<int>(resident_loop::launch(
      resident_nuts_kernel, static_cast<int>(blocks), threads, smem_bytes(threads, pr.n_rows),
      cluster_blocks, stream, theta0, x, y, mask, loc, ivar, inv_mass, mom_scale, pr, samples,
      final_theta, accepts, divergences, steps, cluster_blocks));
}
