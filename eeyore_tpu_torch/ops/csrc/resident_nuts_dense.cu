// The whole fixed-budget NUTS loop for C chains of a sigmoid MLP in one
// kernel, on data of at most 32 rows folded into the code as constants.
//
// Replaces the Pallas TPU kernel eeyore_tpu/ops/resident_nuts_dense.py:360
// (make_resident_nuts_dense); the plain PyTorch version is
// eeyore_tpu_torch/ops/resident_nuts.py::_run_nuts_plain on
// ops/mlp_dense.py::make_vg_dense. The loop is the one of resident_nuts.cu
// (lane_eval.cuh::nuts_chain, here on one thread a chain, Lanes<1>; the same
// NUTS stream keyed by the global chain index); what differs:
// - The value and gradient is dense_body.cuh, which ops/mlp_dense.py
//   generates for one model and dataset, as resident_hmc_dense.cu takes it.
//   No data is staged: a block's shared memory holds the accepted theta.
// - The metric is nuts_metric.cuh, generated by ops/resident_nuts_dense.py
//   with M^-1 and 1/sqrt(M^-1) as constants of the code (the build's name
//   carries its hash): with the loops over parameters unrolled, an entry of 1
//   folds away, so the unit metric costs nothing and gives the same numbers
//   as no metric, as the TPU kernel's im == 1 case (resident_nuts_dense.py:
//   84-91).
// - The tuning groups are the TPU kernel's grid blocks: chain_block chains
//   (a multiple of 1024), sublane-strided (chain s*(C/8) + i*lb + j of
//   group i, lb = chain_block/8), in one block or a thread-block cluster.
// - Registers. A chain's whole tree state on one thread (17 P floats at
//   depth 3) took 172 registers on XOR, so blocks of 256 threads, 8 warps an
//   SM at the main path's 32768 chains, and JAX's group of 8192 chains no
//   cluster held. Launch bounds of one block of NUTS_DENSE_BOUND threads an
//   SM (ops/resident_nuts_dense.py, chosen by scripts/lane_sweep.py) cap
//   them: at 512, 128 registers and a few hundred bytes of spills, a cluster
//   of 16 blocks of 512 holds 8192 chains, and the kernel, bound by latency,
//   ran faster with 16 warps an SM on 64 SMs than with 8 on 128 (PERF.md).
//   Chains on 2 or 4 lanes of a warp over staged rows, and skipping the
//   leaves of a warp whose trees had all stopped, ran slower or no faster
//   and were not kept.
//
// Bound. As resident_nuts.cu: 1 + num_iters (2^D - 1) evaluations a chain
// (the generated body's operations, ops/mlp_dense.py::dense_work), the PRNG
// and the samples' bytes. XOR's evaluation is a few hundred operations, so
// the Threefry words weigh about as much as the evaluations.

#include "lane_eval.cuh"
#include "dense_body.cuh"
#include "nuts_metric.cuh"

#if !defined(NUTS_DEPTH) || !defined(NUTS_DENSE_BOUND)
#error "NUTS_DEPTH (the tree depth) and NUTS_DENSE_BOUND must be defined"
#endif

using namespace mlp_vg;
using resident_loop::kMaxThreads;

static_assert(dense_body::kP == kP, "generated body and architecture disagree");

namespace {

constexpr int kDepth = NUTS_DEPTH;
// Threads a block may have: NUTS_DENSE_BOUND (0: no launch bounds, kMaxThreads).
constexpr int kBlockThreads = NUTS_DENSE_BOUND > 0 ? NUTS_DENSE_BOUND : kMaxThreads;

#if NUTS_DENSE_BOUND > 0
#define NUTS_DENSE_LAUNCH_BOUNDS __launch_bounds__(NUTS_DENSE_BOUND, 1)
#else
#define NUTS_DENSE_LAUNCH_BOUNDS
#endif

struct DenseEval {
  __device__ __forceinline__ float vg(const float (&th)[kP], float (&g)[kP]) const {
    return dense_body::vg(th, g);
  }
};

struct DenseMetric {
  __device__ __forceinline__ float im(int p) const { return nuts_metric::inv_mass(p); }
  __device__ __forceinline__ float msc(int p) const { return nuts_metric::mom_scale(p); }
};

__global__ void NUTS_DENSE_LAUNCH_BOUNDS
    resident_nuts_dense_kernel(const float* __restrict__ theta0,  // [P, C]
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
  float* acc_th = smem;  // accepted theta, [P][bd]
  const int c = resident_loop::chain_index(pr.sublanes, pr.chain_block, pr.num_chains);
  lane_eval::nuts_chain<kDepth>(DenseEval{}, lane_eval::Lanes<1>{}, DenseMetric{}, pr, c,
                                cluster_blocks, theta0, samples, final_theta, accepts,
                                divergences, steps, acc_th, red, partial);
  // no block of a cluster leaves while another may read its partial sum
  if (cluster_blocks > 1) cooperative_groups::this_cluster().sync();
}

size_t smem_bytes(int threads) { return sizeof(float) * static_cast<size_t>(kP) * threads; }

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int resident_nuts_dense_arch(int* out) {
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  out[4] = kMaxThreads;
  return 0;
}

extern "C" int resident_nuts_dense_resources(int* out) {
  return static_cast<int>(resident_loop::resources(resident_nuts_dense_kernel, out));
}

extern "C" int resident_nuts_dense_max_clusters(int threads, int cluster_blocks, int* out) {
  return static_cast<int>(resident_loop::max_active_clusters(
      resident_nuts_dense_kernel, threads, cluster_blocks, smem_bytes(threads), out));
}

extern "C" const char* resident_nuts_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_nuts_dense_launch(const float* theta0, const ResidentHMCParams* params,
                                          int threads, int cluster_blocks, float* samples,
                                          float* final_theta, float* accepts,
                                          float* divergences, float* steps, void* stream) {
  const ResidentHMCParams pr = *params;
  if (threads < 32 || threads > kBlockThreads || threads % 32 != 0 ||
      pr.chain_block % threads != 0 || pr.num_chains % pr.chain_block != 0 ||
      cluster_blocks < 1 || cluster_blocks > resident_loop::kMaxCluster ||
      ((pr.tuned || cluster_blocks > 1) && cluster_blocks * threads != pr.chain_block)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return static_cast<int>(resident_loop::launch(
      resident_nuts_dense_kernel, pr.num_chains / threads, threads, smem_bytes(threads),
      cluster_blocks, stream, theta0, pr, samples, final_theta, accepts, divergences, steps,
      cluster_blocks));
}
