// The whole HMC loop for C chains of a sigmoid MLP in one kernel, on data of
// at most 32 rows folded into the code as constants.
//
// Replaces the Pallas TPU kernel eeyore_tpu/ops/resident_hmc_dense.py:303
// (make_resident_hmc_dense); the plain PyTorch version is the CPU branch of
// eeyore_tpu_torch/ops/resident_hmc_dense.py. The loop is the one of
// resident_hmc.cu (lane_eval.cuh::hmc_chain on one thread a chain,
// Lanes<1>, the same Threefry stream keyed by the global chain index); what
// differs:
// - The value and gradient is dense_body.cuh, which ops/mlp_dense.py
//   generates for one model and dataset (the build's name carries its
//   hash): the rows unrolled, zero inputs' terms dropped and unit inputs
//   added, as the TPU kernel's body (mlp_dense.py:77-211) does. Without fast
//   math nvcc does not fold 0 * w itself, so the generator leaves such terms
//   out. No data is staged: a block's shared memory holds only the accepted
//   theta and gradient.
// - The tuning groups are the TPU kernel's grid blocks: chain_block chains
//   (a multiple of 1024), sublane-strided (chain s*(C/8) + i*lb + j of
//   group i, lb = chain_block/8). A group larger than the block that the
//   registers allow is a thread-block cluster (resident_loop.cuh::
//   group_mean); the wrapper picks the block and cluster sizes and checks
//   that the card can hold the cluster.
// - tuner_mode "per_chain": every chain dual-averages its own step on its
//   own rate (with the l-rule per chain when the tuner has l; a thread
//   simply runs its own trip count where the TPU masks lanes up to the
//   block maximum). A NaN rate statistic counts as 0 in both modes
//   (resident_hmc_dense.py:177).
//
// Bound. As resident_hmc.cu: the evaluations (counted on the device), the
// PRNG and the samples' bytes. XOR's evaluation is about a hundred
// operations, so the Threefry and Box-Muller work and the sample bytes weigh
// as much as the evaluations.

#include "lane_eval.cuh"
#include "dense_body.cuh"

using namespace mlp_vg;
using resident_loop::kMaxThreads;

static_assert(dense_body::kP == kP, "generated body and architecture disagree");

namespace {

struct DenseEval {
  __device__ __forceinline__ float vg(const float (&th)[kP], float (&g)[kP]) const {
    return dense_body::vg(th, g);
  }
  __device__ __forceinline__ float v(const float (&th)[kP]) const { return dense_body::v(th); }
};

__global__ void resident_hmc_dense_kernel(const float* __restrict__ theta0,  // [P, C]
                                          const ResidentHMCParams pr,
                                          float* __restrict__ samples,      // [kept, rows, C]
                                          float* __restrict__ final_theta,  // [P, C]
                                          float* __restrict__ accepts,      // [C]
                                          unsigned long long* __restrict__ evaluations,
                                          int cluster_blocks) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxThreads / 32];
  __shared__ float partial[2];
  // smem: the accepted theta and its gradient, [P][bd] each
  const int c = resident_loop::chain_index(pr.sublanes, pr.chain_block, pr.num_chains);
  lane_eval::hmc_chain(DenseEval{}, lane_eval::Lanes<1>{}, pr, c, cluster_blocks, theta0,
                       samples, final_theta, accepts, evaluations, smem, red, partial);
  // no block of a cluster leaves while another may read its partial sum
  if (cluster_blocks > 1) cooperative_groups::this_cluster().sync();
}

size_t smem_bytes(int threads) { return sizeof(float) * 2 * static_cast<size_t>(kP) * threads; }

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int resident_hmc_dense_arch(int* out) {
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  out[4] = kMaxThreads;
  return 0;
}

extern "C" int resident_hmc_dense_resources(int* out) {
  return static_cast<int>(resident_loop::resources(resident_hmc_dense_kernel, out));
}

extern "C" int resident_hmc_dense_max_clusters(int threads, int cluster_blocks, int* out) {
  return static_cast<int>(resident_loop::max_active_clusters(
      resident_hmc_dense_kernel, threads, cluster_blocks, smem_bytes(threads), out));
}

extern "C" const char* resident_hmc_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_hmc_dense_launch(const float* theta0, const ResidentHMCParams* params,
                                         int threads, int cluster_blocks, float* samples,
                                         float* final_theta, float* accepts,
                                         unsigned long long* evaluations, void* stream) {
  const ResidentHMCParams pr = *params;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      pr.chain_block % threads != 0 || pr.num_chains % pr.chain_block != 0 ||
      cluster_blocks < 1 || cluster_blocks > resident_loop::kMaxCluster ||
      (cluster_blocks > 1 && cluster_blocks * threads != pr.chain_block)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return static_cast<int>(resident_loop::launch(
      resident_hmc_dense_kernel, pr.num_chains / threads, threads, smem_bytes(threads),
      cluster_blocks, stream, theta0, pr, samples, final_theta, accepts, evaluations,
      cluster_blocks));
}
