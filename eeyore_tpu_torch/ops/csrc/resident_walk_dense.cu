// The whole random-walk MH, MALA or blocked-Gibbs loop for C chains of a
// sigmoid MLP in one kernel, on data of at most 32 rows folded into the code
// as constants.
//
// Replaces the MH, MALA, Gibbs and tempering moves of the Pallas TPU kernel
// eeyore_tpu/ops/resident_walk_dense.py:125 (_make_resident_dense, behind
// make_resident_mh_dense :196, make_resident_mala_dense :309,
// make_resident_gibbs_dense :240 and
// eeyore_tpu/ops/resident_tempering_dense.py:150); the plain PyTorch
// versions are the CPU branches of eeyore_tpu_torch/ops/resident_walk_dense.py.
// The loops are lane_eval.cuh::walk_chain on one thread a chain, Lanes<1>
// (move 0: MH, value only; move 1: MALA), and resident_loop.cuh::
// tempering_chain (move 3: a power-posterior ladder, MH or MALA
// within each rung by the template flag kMALA; a block holds whole ladders of
// the sublane-strided chain layout, which needs chain_block / 8 and the block
// to be multiples of the ladder size), on
// the generated body dense_body.cuh (ops/mlp_dense.py), as in
// resident_hmc_dense.cu, and gibbs_chain (move 2) on the generated
// incremental body dense_gibbs.cuh and the blocking gibbs_blocks.cuh: the
// per-chain cache of activations and output terms (one float per unit and
// data row; 12 for MLP(2,2,1) on XOR) stays in registers, a sub-block
// proposal recomputes only its unit and what lies downstream into a copy of
// the entries they touch, and an accepted one commits those. With a tuner the scale
// (MH) or step (MALA) is dual-averaged during burn-in on the mean rate of
// each tuning group, the TPU kernel's sublane-strided grid block of
// chain_block chains, one CUDA block or a thread-block cluster
// (_population_dual_average, resident_walk_dense.py:175-193). As there, the
// rates have no NaN guard.
//
// Bound. As resident_walk.cu: one evaluation per chain and iteration (one
// incremental update per sub-block for Gibbs), the PRNG and the samples'
// bytes; on XOR the PRNG work and the sample bytes weigh as much as the
// evaluations.

#include "lane_eval.cuh"
#include "dense_body.cuh"
#include "dense_gibbs.cuh"
#include "gibbs_blocks.cuh"

using namespace mlp_vg;
using resident_loop::kMaxThreads;

static_assert(dense_body::kP == kP, "generated body and architecture disagree");

namespace {

struct DenseEval {
  __device__ __forceinline__ float vg(const float (&th)[kP], float (&g)[kP]) const {
    return dense_body::vg(th, g);
  }
  __device__ __forceinline__ float v(const float (&th)[kP]) const { return dense_body::v(th); }
  static constexpr int kCache = dense_gibbs::kCache;
  __device__ __forceinline__ float init(const float (&th)[kP], float (&c)[kCache]) const {
    return dense_gibbs::init(th, c);
  }
  template <int U>
  __device__ __forceinline__ float update(const float (&th)[kP], const float (&c)[kCache],
                                          float (&n)[kCache]) const {
    return dense_gibbs::update<U>(th, c, n);
  }
  template <int U>
  __device__ __forceinline__ void commit(float (&c)[kCache], const float (&n)[kCache]) const {
    dense_gibbs::commit<U>(c, n);
  }
};

template <bool kMALA>
__global__ void resident_walk_dense_kernel(const float* __restrict__ theta0,  // [P, C]
                                           const ResidentWalkParams pr,
                                           float* __restrict__ samples,      // [kept, rows, C]
                                           float* __restrict__ final_theta,  // [P, C]
                                           float* __restrict__ accepts,      // [C]
                                           int cluster_blocks) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxThreads / 32];
  __shared__ float partial[2];
  // smem: the accepted theta and (MALA) its gradient, [P][bd] each
  const int c = resident_loop::chain_index(pr.sublanes, pr.chain_block, pr.num_chains);
  lane_eval::walk_chain<kMALA>(DenseEval{}, lane_eval::Lanes<1>{}, pr, c, cluster_blocks, theta0,
                               samples, final_theta, accepts, smem, red, partial);
  // no block of a cluster leaves while another may read its partial sum
  if (cluster_blocks > 1) cooperative_groups::this_cluster().sync();
}

__global__ void resident_walk_dense_gibbs_kernel(const float* __restrict__ theta0,  // [P, C]
                                                 const float* __restrict__ scales,  // [kB]
                                                 const ResidentWalkParams pr,
                                                 float* __restrict__ samples,  // [kept, rows, C]
                                                 float* __restrict__ final_theta,  // [P, C]
                                                 float* __restrict__ accepts) {    // [kB, C]
  const int c = resident_loop::chain_index(pr.sublanes, pr.chain_block, pr.num_chains);
  resident_loop::gibbs_chain<DenseEval, GibbsBlocks>(DenseEval{}, pr, c, theta0, scales, samples,
                                                     final_theta, accepts);
}

template <bool kMALA>
__global__ void resident_walk_dense_tempering_kernel(const float* __restrict__ theta0,  // [P, C]
                                                     const float* __restrict__ temps,   // [L]
                                                     const ResidentWalkParams pr,
                                                     float* __restrict__ samples,
                                                     float* __restrict__ final_theta,  // [P, C]
                                                     float* __restrict__ accepts) {    // [2, C]
  extern __shared__ float smem[];
  const int c = resident_loop::chain_index(pr.sublanes, pr.chain_block, pr.num_chains);
  resident_loop::tempering_chain<DenseEval, kMALA>(DenseEval{}, pr, c, theta0, temps, samples,
                                                   final_theta, accepts, smem);
}

size_t smem_bytes(int move, int threads) {
  return sizeof(float) * (move == 1 ? 2 : 1) * static_cast<size_t>(kP) * threads;
}

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int resident_walk_dense_arch(int* out) {
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  out[4] = kMaxThreads;
  return 0;
}

extern "C" int resident_walk_dense_num_sub_blocks() { return GibbsBlocks::kB; }

// move: 0 MH, 1 MALA, 2 Gibbs, 3 tempering with MH, 4 tempering with MALA.
extern "C" int resident_walk_dense_resources(int move, int* out) {
  if (move == 2) {
    return static_cast<int>(resident_loop::resources(resident_walk_dense_gibbs_kernel, out));
  }
  if (move == 3 || move == 4) {
    return static_cast<int>(
        move == 4 ? resident_loop::resources(resident_walk_dense_tempering_kernel<true>, out)
                  : resident_loop::resources(resident_walk_dense_tempering_kernel<false>, out));
  }
  return static_cast<int>(
      move == 1 ? resident_loop::resources(resident_walk_dense_kernel<true>, out)
                : resident_loop::resources(resident_walk_dense_kernel<false>, out));
}

extern "C" int resident_walk_dense_max_clusters(int move, int threads, int cluster_blocks,
                                                int* out) {
  const size_t smem = smem_bytes(move, threads);
  return static_cast<int>(
      move == 1 ? resident_loop::max_active_clusters(resident_walk_dense_kernel<true>, threads,
                                                     cluster_blocks, smem, out)
                : resident_loop::max_active_clusters(resident_walk_dense_kernel<false>, threads,
                                                     cluster_blocks, smem, out));
}

extern "C" const char* resident_walk_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_walk_dense_launch(int move, const float* theta0,
                                          const ResidentWalkParams* params, int threads,
                                          int cluster_blocks, float* samples,
                                          float* final_theta, float* accepts, void* stream) {
  const ResidentWalkParams pr = *params;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      pr.chain_block % threads != 0 || pr.num_chains % pr.chain_block != 0 ||
      cluster_blocks < 1 || cluster_blocks > resident_loop::kMaxCluster ||
      (cluster_blocks > 1 && cluster_blocks * threads != pr.chain_block) ||
      (move != 0 && move != 1)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = smem_bytes(move, threads);
  const int blocks = pr.num_chains / threads;
  const cudaError_t err =
      move == 1 ? resident_loop::launch(resident_walk_dense_kernel<true>, blocks, threads, smem,
                                        cluster_blocks, stream, theta0, pr, samples,
                                        final_theta, accepts, cluster_blocks)
                : resident_loop::launch(resident_walk_dense_kernel<false>, blocks, threads, smem,
                                        cluster_blocks, stream, theta0, pr, samples,
                                        final_theta, accepts, cluster_blocks);
  return static_cast<int>(err);
}

extern "C" int resident_walk_dense_gibbs_launch(const float* theta0, const float* scales,
                                                const ResidentWalkParams* params, int threads,
                                                float* samples, float* final_theta,
                                                float* accepts, void* stream) {
  const ResidentWalkParams pr = *params;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      pr.chain_block % threads != 0 || pr.num_chains % pr.chain_block != 0 || pr.tuned) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // no shared memory: theta and the cache live in registers
  return static_cast<int>(resident_loop::launch(resident_walk_dense_gibbs_kernel,
                                                pr.num_chains / threads, threads, 0, 1, stream,
                                                theta0, scales, pr, samples, final_theta,
                                                accepts));
}

extern "C" int resident_walk_dense_tempering_launch(int mala, const float* theta0,
                                                    const float* temps,
                                                    const ResidentWalkParams* params,
                                                    int threads, float* samples,
                                                    float* final_theta, float* accepts,
                                                    void* stream) {
  const ResidentWalkParams pr = *params;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      pr.chain_block % threads != 0 || pr.num_chains % pr.chain_block != 0 || pr.tuned ||
      pr.num_rungs < 1 || threads % pr.num_rungs != 0 ||
      (pr.chain_block / pr.sublanes) % pr.num_rungs != 0 || pr.between_step < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem =
      sizeof(float) * resident_loop::tempering_floats(mala != 0, pr.record_extras != 0, threads);
  const int blocks = pr.num_chains / threads;
  const cudaError_t err =
      mala ? resident_loop::launch(resident_walk_dense_tempering_kernel<true>, blocks, threads,
                                   smem, 1, stream, theta0, temps, pr, samples, final_theta,
                                   accepts)
           : resident_loop::launch(resident_walk_dense_tempering_kernel<false>, blocks, threads,
                                   smem, 1, stream, theta0, temps, pr, samples, final_theta,
                                   accepts);
  return static_cast<int>(err);
}
