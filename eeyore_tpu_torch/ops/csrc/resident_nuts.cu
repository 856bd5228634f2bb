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
// does. The loop is resident_loop.cuh::nuts_chain, shared with
// resident_nuts_dense.cu.
//
// Design.
// - One thread per chain. The TPU kernel unrolls the doublings and the
//   leaves and keeps the checkpoint stack in static slots; here both are
//   loops over the compile-time depth (NUTS_DEPTH), a thread takes its own
//   branches (direction, proposals, merges) where the TPU masks lanes, and
//   the stack is indexed by popcount(n) at run time, so it lives in local
//   memory. The tree's other vectors stay in registers as far as they go;
//   on iris (P = 27) they do not, and the rest spills to local memory (the
//   build phase of chip_smoke.py reports both).
// - The tuning group is the chain_block consecutive chains: one CUDA block,
//   or a thread-block cluster of up to 16 blocks when the group is larger
//   than the registers allow a block to be (resident_loop.cuh::group_mean).
// - Shared memory: the data rows and prior constants, the metric (M^-1 and
//   1/sqrt(M^-1), ones for none) and the accepted theta [P][blockDim].
// - Samples are written chain-minor, [kept, rows, C].
//
// Bound. Every chain evaluates the value and gradient 1 + num_iters (2^D - 1)
// times (each bound by the special-function unit on iris,
// chip_smoke.py::vg_work), plus per iteration ceil(P/2) Box-Muller pairs and
// 2^D - 1 + 2D more Threefry words, plus kept x P x C x 4 bytes of samples.
// On iris the evaluations dominate, so the kernel is bound by operations.

#include "resident_loop.cuh"

#ifndef NUTS_DEPTH
#error "NUTS_DEPTH (the tree depth) must be defined"
#endif

using namespace mlp_vg;
using resident_loop::kMaxThreads;

namespace {

constexpr int kDepth = NUTS_DEPTH;

__global__ void resident_nuts_kernel(const float* __restrict__ theta0,  // [P, C]
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
  float* acc_th = metric + 2 * kP;  // accepted theta, [P][bd]
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const resident_loop::StagedEval ev{d, pr.prior_const, pr.temperature, pr.n_rows};
  resident_loop::nuts_chain<kDepth>(ev, resident_loop::ArrayMetric{metric, metric + kP}, pr, c,
                                    cluster_blocks, theta0, samples, final_theta, accepts,
                                    divergences, steps, acc_th, red, partial);
  // no block of a cluster leaves while another may read its partial sum
  if (cluster_blocks > 1) cooperative_groups::this_cluster().sync();
}

size_t smem_bytes(int threads, int n_rows) {
  return sizeof(float) * (data_floats(n_rows) + 2 * static_cast<size_t>(kP) +
                          static_cast<size_t>(kP) * threads);
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

extern "C" int resident_nuts_resources(int* out) {
  return static_cast<int>(resident_loop::resources(resident_nuts_kernel, out));
}

extern "C" int resident_nuts_max_clusters(int threads, int cluster_blocks, int n_rows, int* out) {
  return static_cast<int>(resident_loop::max_active_clusters(
      resident_nuts_kernel, threads, cluster_blocks, smem_bytes(threads, n_rows), out));
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
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      pr.chain_block % threads != 0 || pr.num_chains % pr.chain_block != 0 ||
      cluster_blocks < 1 || cluster_blocks > resident_loop::kMaxCluster ||
      ((pr.tuned || cluster_blocks > 1) && cluster_blocks * threads != pr.chain_block)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return static_cast<int>(resident_loop::launch(
      resident_nuts_kernel, pr.num_chains / threads, threads, smem_bytes(threads, pr.n_rows),
      cluster_blocks, stream, theta0, x, y, mask, loc, ivar, inv_mass, mom_scale, pr, samples,
      final_theta, accepts, divergences, steps, cluster_blocks));
}
