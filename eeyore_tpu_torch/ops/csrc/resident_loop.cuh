// The per-chain loops of the whole-loop kernels, written once for both data
// strategies.
//
// gibbs_chain is one chain's whole blocked-Gibbs run (resident_walk.cu and
// resident_walk_dense.cu). The whole HMC, MH and MALA runs (hmc_chain,
// walk_chain), the power-posterior ladder (tempering_chain) and the NUTS
// run (nuts_chain) are written once over the lanes a chain in lane_eval.cuh,
// one thread a chain being Lanes<1>; this header keeps their scalar pieces
// (draw counts, group means, dual averaging, the thread layout's record, the
// ladder's barrier). The data strategy is the Eval argument: an object
// with vg(th, g) -> value (gradient into g) and v(th) -> value, and for Gibbs
// the cached value-only interface described at gibbs_chain. StagedEval reads
// the rows a block staged in shared memory (mlp_vg.cuh), one thread a chain;
// lane_eval.cuh's evaluators read them a group of lanes a chain (the staged
// HMC, MH, MALA and Gibbs moves and NUTS); the dense kernels' evaluator
// calls the code generated for one dataset (ops/mlp_dense.py::dense_source,
// gibbs_dense_source). SplitEval is the staged rows with the
// likelihood-tempered target of the SMC mutation pass (resident_smc.cu, on
// one thread a particle; lane_eval.cuh::smc_chain is the pass, written once
// over the lanes a particle).
//
// Layout and state. One thread owns one chain in the dense HMC, NUTS and
// Gibbs kernels and the SMC closure pass (and in the staged kernels, the
// dense MH, MALA and ladder moves and the SMC mutation pass when the data has
// few rows, a tuning group is larger than a cluster of lane blocks holds or
// a ladder longer than a block of lane chains); a group of lanes of a warp
// owns it otherwise (lane_eval.cuh). On one thread the accepted
// theta (and its gradient, for HMC and MALA), touched once per iteration,
// live in shared memory at [P][blockDim]; the proposal and its gradient live
// in registers (Gibbs keeps theta in registers and saves only the sub-block
// it moves). Samples are written chain-minor, [kept, rows, C] with rows = P
// (+2 with record_extras: the value and the moved flag), so a warp's stores
// are coalesced (a chain on lanes records through a shared-memory tile). The
// [P*8, C/8] tiles of the TPU's dense layout are this same [P, C] array, so
// the dense kernels write the same layout.
//
// Tuning groups. A tuned population run applies one dual-averaging update
// to every chain of a group of chain_block chains, on the mean of their
// acceptance rates. A group is one CUDA block, or a thread-block cluster of
// cluster_blocks blocks when it is larger than a block can be: each block
// reduces its rates (warp shuffles, then shared memory), writes its sum to
// shared memory, and every block adds all blocks' sums through distributed
// shared memory in rank order, so all blocks apply the same update bit for
// bit. Staged kernels group consecutive chains; dense kernels (sublanes = 8)
// group the TPU's sublane-strided sets s*(C/8) + i*lb + j (lb = chain_block /
// 8), the chains of grid block i of the TPU kernel.
//
// NUTS. The fixed-budget NUTS loop is lane_eval.cuh::nuts_chain, written
// once over the lanes a chain: one thread a chain (resident_nuts_dense.cu,
// and resident_nuts.cu for tuning groups of more than 256 chains) or a group
// of lanes of a warp (resident_nuts.cu); this header keeps its scalar pieces.
//
// Ladders. lane_eval.cuh::tempering_chain runs L consecutive chains as one
// power-posterior ladder (rung = chain % L, the coldest last). A block holds
// whole ladders (blockDim.x a multiple of L times the lanes a chain; on the
// dense kernels also chain_block / 8), so the partner one rung up of a chain
// is the next chain of its block, and an accepted swap exchanges the pair's
// states through shared memory.

#pragma once

#include <cooperative_groups.h>

#include "kernel_prng.cuh"
#include "mlp_vg.cuh"

// Scalar arguments of the HMC kernels, in the order of ResidentHMCParams in
// ops/resident_hmc.py.
struct ResidentHMCParams {
  int seed;
  int num_chains;
  int n_rows;
  int num_iters;
  int num_burnin_iters;
  int record_thin;
  int kept;
  int num_steps;      // initial trajectory length
  int tuned;          // 1: dual averaging during burn-in
  int stochastic;     // 1: freeze per-chain num_steps by stochastic rounding
  int max_num_steps;
  int record_extras;  // 1: rows P and P+1 hold the value and the moved flag
  int per_chain;      // 1: each chain tunes on its own rate (dense only)
  int use_l;          // 1: the l-rule sets num_steps while tuning
  int nan_guard;      // 1: a NaN rate statistic counts as 0 (dense only)
  int sublanes;       // 1: consecutive chains per group; 8: sublane-strided
  int chain_block;    // chains per tuning group
  float step;         // initial step
  float tuner_m;      // log(10 * step)
  float d, g, t0, k, l;
  float log_eub;      // +inf without an upper bound
  float prior_const;
  float temperature;
};

// Scalar arguments of the walk kernels, in the order of ResidentWalkParams
// in ops/resident_walk.py.
struct ResidentWalkParams {
  int seed;
  int num_chains;
  int n_rows;
  int num_iters;
  int num_burnin_iters;
  int record_thin;
  int kept;
  int record_extras;
  int tuned;          // 1: dual-average the scale (MH) or step (MALA)
  int sublanes;
  int chain_block;
  float value;        // MH proposal scale, or MALA step
  float half_step;    // MALA, untuned: 0.5 * step
  float sqrt_step;    // MALA, untuned: sqrt(step)
  float half_inv_step;  // MALA, untuned: 0.5 / step
  float tuner_m;      // log(10 * value)
  float d, g, t0, k;
  float log_eub;
  float prior_const;
  float temperature;
  int num_rungs;      // tempering: rungs of a ladder (L)
  int between_step;   // tempering: iterations between swap rounds
};

// Scalar arguments of the SMC mutation kernel, in the order of
// ResidentSMCParams in ops/resident_smc.py.
struct ResidentSMCParams {
  int seed;             // the stage's seed
  int num_particles;
  int n_rows;
  int num_steps;        // mutation steps per particle
  float beta;           // the stage's temperature on the likelihood
  float sqrt_step;      // sqrt(step): the MALA noise scale and the MH proposal scale
  float half_step;      // MALA: 0.5 * step
  float half_inv_step;  // MALA: 0.5 / step
  float prior_const;
};

namespace resident_loop {

namespace cg = cooperative_groups;
using mlp_vg::kP;

constexpr int kPairs = (kP + 1) / 2;  // Box-Muller pairs per iteration
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;       // non-portable cluster size of Hopper

// The data staged in shared memory by a block.
struct StagedEval {
  mlp_vg::Data d;
  float prior_const;
  float temperature;
  int n_rows;
  __device__ __forceinline__ float vg(const float (&th)[kP], float (&g)[kP]) const {
    return mlp_vg::chain_vg(th, d, prior_const, temperature, n_rows, g);
  }
  __device__ __forceinline__ float v(const float (&th)[kP]) const {
    return mlp_vg::chain_v(th, d, prior_const, temperature, n_rows);
  }
};

// The staged rows with the SMC target lp + beta * ll, beta taken at run
// time: each call returns the target's value and writes the untempered
// log-likelihood to ll (vg: the combined gradient to g).
struct SplitEval {
  mlp_vg::Data d;
  float prior_const;
  float beta;
  int n_rows;
  __device__ __forceinline__ float vg(const float (&th)[kP], float (&g)[kP], float& ll) const {
    const float2 s = mlp_vg::chain_eval_split<true>(th, d, prior_const, beta, n_rows, g);
    ll = s.x;
    return s.y + beta * s.x;
  }
  __device__ __forceinline__ float v(const float (&th)[kP], float& ll) const {
    float unused[kP];
    const float2 s = mlp_vg::chain_eval_split<false>(th, d, prior_const, beta, n_rows, unused);
    ll = s.x;
    return s.y + beta * s.x;
  }
};

// The chain of this thread, whose chain takes lanes consecutive threads (a
// block holding nb = blockDim.x / lanes chains). Staged (sublanes 1):
// consecutive, block by block. Dense (sublanes 8): the blocks of a group
// (chain_block / nb of them, in order) hold its chains s*(C/8) + i*lb + j in
// the order (s, j), so a warp's chains are consecutive (lb is a multiple of
// 128), and a block's too where nb divides lb, as the dense launches take it.
__device__ __forceinline__ int chain_index(int sublanes, int chain_block, int num_chains,
                                           int lanes = 1) {
  const int nb = blockDim.x / lanes;
  const int slot = threadIdx.x / lanes;
  if (sublanes == 1) return blockIdx.x * nb + slot;
  const int blocks_per_group = chain_block / nb;
  const int group = blockIdx.x / blocks_per_group;
  const int q = (blockIdx.x % blocks_per_group) * nb + slot;
  const int lb = chain_block / sublanes;
  return (q / lb) * (num_chains / sublanes) + group * lb + q % lb;
}

// Mean of v over the tuning group (every thread of the block, or of the
// cluster, calls it; blockDim.x a multiple of 32); every thread returns the
// same value. red: 32 floats of shared memory; partial: 2 floats of shared
// memory, written alternately by parity, so one cluster barrier per call
// orders each block's write after every read of the call before last.
__device__ __forceinline__ float group_mean(float v, float* red, float* partial, int parity,
                                            int cluster_blocks) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warps = blockDim.x >> 5;
  __syncthreads();  // the previous call's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < warps; ++w) s += red[w];
  if (cluster_blocks == 1) return s / static_cast<float>(blockDim.x);
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) partial[parity] = s;
  cluster.sync();
  float total = 0.0f;
  for (int r = 0; r < cluster_blocks; ++r) {
    total += *cluster.map_shared_rank(partial + parity, static_cast<unsigned>(r));
  }
  return total / static_cast<float>(blockDim.x * cluster_blocks);
}

// Adds this thread's evaluation count to the launch's total: one atomic per
// warp.
__device__ __forceinline__ void count_evaluations(unsigned evals,
                                                  unsigned long long* __restrict__ total) {
  const unsigned mask = __activemask();
  const unsigned sum = __reduce_add_sync(mask, evals);
  if ((threadIdx.x & 31) == __ffs(mask) - 1) atomicAdd(total, static_cast<unsigned long long>(sum));
}

// Writes the accepted state of recorded iteration t (and the value and moved
// flag with extras).
__device__ __forceinline__ void record(float* __restrict__ samples, int t, int num_burnin_iters,
                                       int record_thin, int kept, int record_extras, int C, int c,
                                       const float* acc_th, float val, bool moved) {
  const int since = t - num_burnin_iters;
  if (since < 0 || since % record_thin != 0 || since / record_thin >= kept) return;
  const int rows = record_extras ? kP + 2 : kP;
  const int bd = blockDim.x;
  float* out = samples + static_cast<size_t>(since / record_thin) * rows * C;
#pragma unroll
  for (int p = 0; p < kP; ++p) out[static_cast<size_t>(p) * C + c] = acc_th[p * bd + threadIdx.x];
  if (record_extras) {
    out[static_cast<size_t>(kP) * C + c] = val;
    out[static_cast<size_t>(kP + 1) * C + c] = moved ? 1.0f : 0.0f;
  }
}

// One dual-averaging update at iteration t (Hoffman and Gelman, Alg. 5):
// returns the new step (the averaged one at the last burn-in iteration).
__device__ __forceinline__ float dual_average(float stat, int t, int num_burnin_iters,
                                              float tuner_m, float d, float g, float t0,
                                              float k, float log_eub, float& barh,
                                              float& logbare) {
  const float it = static_cast<float>(t + 1);
  const float d_w = 1.0f / (it + t0);
  const float e_w = expf(-k * logf(it));  // it ** -k
  barh = (1.0f - d_w) * barh + d_w * (d - stat);
  float loge = tuner_m - sqrtf(it) * barh / g;
  loge = loge > log_eub ? log_eub : loge;  // NaN stays NaN
  logbare = e_w * loge + (1.0f - e_w) * logbare;
  return t == num_burnin_iters - 1 ? expf(logbare) : expf(loge);
}

// Floats of shared memory that lane_eval.cuh::tempering_chain takes on one
// thread a chain for a block of bd threads: theta [P][bd], its gradient
// [P][bd] (MALA), the values [bd], and with extras theta at the start of a
// recorded swap iteration [P][bd].
__host__ __device__ constexpr size_t tempering_floats(bool mala, bool extras, int bd) {
  return ((1 + (mala ? 1 : 0) + (extras ? 1 : 0)) * static_cast<size_t>(kP) + 1) * bd;
}

// A barrier of a swap round, reached by every thread of the block: a warp's
// when whole ladders fit a warp, else the block's.
__device__ __forceinline__ void ladder_sync(bool warp_local) {
  if (warp_local) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// The layout of a chain that one thread owns (gibbs_chain's default): the
// draws of sub-block b where they are used, the record and the final state
// written by the thread. lane_eval.cuh::LaneGibbsLayout is the one of a chain
// on a group of lanes.
struct ThreadGibbsLayout {
  __device__ __forceinline__ void begin(unsigned, unsigned, unsigned) const {}
  template <int b, int W>
  __device__ __forceinline__ void normals(unsigned key0, unsigned key1, unsigned ctr,
                                          float (&z)[W]) const {
    kernel_prng::normals(key0, key1, ctr, z, static_cast<unsigned>(b) * kernel_prng::kGibbsStride);
  }
  template <int b, int W>
  __device__ __forceinline__ float uniform(unsigned key0, unsigned key1, unsigned ctr) const {
    return kernel_prng::uniform_at(
        key0, key1, ctr, static_cast<unsigned>(b) * kernel_prng::kGibbsStride + (W + 1) / 2);
  }
  __device__ __forceinline__ void record(float* __restrict__ samples, int k, int, int C, int c,
                                         bool extras, const float (&th)[kP], float val,
                                         bool moved) const {
    const int rows = extras ? kP + 2 : kP;
    float* out = samples + static_cast<size_t>(k) * rows * C;
#pragma unroll
    for (int p = 0; p < kP; ++p) out[static_cast<size_t>(p) * C + c] = th[p];
    if (extras) {
      out[static_cast<size_t>(kP) * C + c] = val;
      out[static_cast<size_t>(kP + 1) * C + c] = moved ? 1.0f : 0.0f;
    }
  }
  template <int kB>
  __device__ __forceinline__ void finish(float* __restrict__ final_theta,
                                         float* __restrict__ accepts, int C, int c,
                                         const float (&th)[kP], const float (&n)[kB]) const {
#pragma unroll
    for (int p = 0; p < kP; ++p) final_theta[static_cast<size_t>(p) * C + c] = th[p];
#pragma unroll
    for (int b = 0; b < kB; ++b) accepts[static_cast<size_t>(b) * C + c] = n[b];
  }
};

// Sub-block b, and those after it, of one Gibbs sweep (see gibbs_chain).
template <class Eval, class Blocks, int b, class Layout>
__device__ __forceinline__ void gibbs_sub_blocks(const Eval& ev, const Layout& layout,
                                                 unsigned key0, unsigned key1, unsigned ctr,
                                                 const float* __restrict__ scales, bool counting,
                                                 float (&th)[kP], float (&cache)[Eval::kCache],
                                                 float& val, float (&n_accepts)[Blocks::kB],
                                                 bool& moved) {
  if constexpr (b < Blocks::kB) {
    constexpr int w = Blocks::width(b);
    float z[w];
    layout.template normals<b>(key0, key1, ctr, z);
    const float scale = scales[b];
    float old[w];
#pragma unroll
    for (int k = 0; k < w; ++k) {
      old[k] = th[Blocks::index(b, k)];
      th[Blocks::index(b, k)] = old[k] + scale * z[k];
    }
    float next[Eval::kCache];
    const float v_p = ev.template update<Blocks::unit(b)>(th, cache, next);
    const float u = layout.template uniform<b, w>(key0, key1, ctr);
    if (logf(u) < v_p - val) {
#pragma unroll
      for (int k = 0; k < w; ++k) moved |= th[Blocks::index(b, k)] != old[k];
      ev.template commit<Blocks::unit(b)>(cache, next);
      val = v_p;
      if (counting) n_accepts[b] += 1.0f;
    } else {
#pragma unroll
      for (int k = 0; k < w; ++k) th[Blocks::index(b, k)] = old[k];
    }
    gibbs_sub_blocks<Eval, Blocks, b + 1>(ev, layout, key0, key1, ctr, scales, counting, th,
                                          cache, val, n_accepts, moved);
  }
}

// One chain's whole blocked-Gibbs run. Per iteration t, a systematic sweep
// over the Blocks::kB sub-blocks (compile-time tables from the generated
// gibbs_blocks.cuh: width(b), index(b, k), and unit(b), the node block
// whose incoming weights and bias sub-block b holds). Sub-block b draws
// width(b) normals z and one uniform u from the Gibbs stream (key (seed,
// chain), counter (t, b * 2^16 + j)), proposes theta[index(b, k)] + scale_b
// z[k] on its own coordinates only, and accepts when log(u) < v(prop) -
// v(theta); a rejected proposal is restored before the next sub-block.
// Eval is value only: ev.init(th, cache) -> value fills the evaluator's
// cache, ev.update<U>(prop, cache, next) -> value evaluates a proposal that
// moved unit U (writing the cache entries it changes into next) and
// ev.commit<U>(cache, next) keeps them. The dense evaluator recomputes unit
// U and everything downstream from a per-chain cache in registers; the
// staged one (lane_eval.cuh::LaneGibbsEval) does so per lane, over the
// lane's own rows.
//
// Layout: one thread a chain (ThreadGibbsLayout, the dense kernel), or a
// group of lanes a chain (lane_eval.cuh::LaneGibbsLayout, the staged
// kernel), which draws the sweep's words at its start (layout.begin) and
// records through shared memory. theta lives in registers, whole in every
// lane (each coordinate is indexed at compile time once the sweep unrolls),
// the counts of each sub-block too; accepts is [kB, C]. The moved flag is
// true when theta differs from theta at the start of the sweep (each
// coordinate belongs to at most one sub-block of a sweep).
template <class Eval, class Blocks, class Layout = ThreadGibbsLayout>
__device__ __forceinline__ void gibbs_chain(const Eval& ev, const ResidentWalkParams& pr, int c,
                                            const float* __restrict__ theta0,
                                            const float* __restrict__ scales,
                                            float* __restrict__ samples,
                                            float* __restrict__ final_theta,
                                            float* __restrict__ accepts,
                                            Layout layout = Layout{}) {
  const int C = pr.num_chains;
  const unsigned key0 = static_cast<unsigned>(pr.seed);
  const unsigned key1 = static_cast<unsigned>(c);
  float th[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) th[p] = theta0[static_cast<size_t>(p) * C + c];
  float cache[Eval::kCache];
  float val = ev.init(th, cache);
  float n_accepts[Blocks::kB];
#pragma unroll
  for (int b = 0; b < Blocks::kB; ++b) n_accepts[b] = 0.0f;

  for (int t = 0; t < pr.num_iters; ++t) {
    bool moved = false;
    layout.begin(key0, key1, static_cast<unsigned>(t));
    gibbs_sub_blocks<Eval, Blocks, 0>(ev, layout, key0, key1, static_cast<unsigned>(t), scales,
                                      t >= pr.num_burnin_iters, th, cache, val, n_accepts, moved);
    const int since = t - pr.num_burnin_iters;
    if (since >= 0 && since % pr.record_thin == 0 && since / pr.record_thin < pr.kept) {
      layout.record(samples, since / pr.record_thin, pr.kept, C, c, pr.record_extras != 0, th,
                    val, moved);
    }
  }
  layout.finish(final_theta, accepts, C, c, th, n_accepts);
}

// ---- fixed-budget NUTS ----

constexpr float kDivergence = 1000.0f;  // Stan's divergence threshold on the log weight

// A diagonal metric at run time: M^-1 and 1/sqrt(M^-1) in shared memory [P]
// each (ones for the unit metric, which gives the same numbers).
struct ArrayMetric {
  const float* inv_mass;
  const float* scale;
  __device__ __forceinline__ float im(int p) const { return inv_mass[p]; }
  __device__ __forceinline__ float msc(int p) const { return scale[p]; }
};

// log(e^a + e^b), the TPU kernels' form: a NaN-propagating max, and -inf
// (not NaN) when both are -inf.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = (a != a || a > b) ? a : b;
  if (m == -INFINITY) return m;
  return m + log1pf(expf(-fabsf(a - b)));
}

// ---- host side ----

// Raises kernel's dynamic shared memory limit to smem bytes where it is
// lower, and never lowers it: an occupancy query (max_active_blocks,
// max_active_clusters) then leaves a later launch the room it had.
template <typename... Params>
inline cudaError_t allow_smem(void (*kernel)(Params...), size_t smem) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess || static_cast<size_t>(attr.maxDynamicSharedSizeBytes) >= smem) {
    return err;
  }
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launches kernel on blocks x threads with smem bytes of dynamic shared
// memory, in clusters of cluster_blocks blocks when that is above 1.
template <typename... Params, typename... Args>
inline cudaError_t launch(void (*kernel)(Params...), int blocks, int threads, size_t smem,
                          int cluster_blocks, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  if (cluster_blocks > 1) {
    if (cluster_blocks > 8) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster_blocks);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of cluster_blocks blocks of threads threads (with smem
// bytes of dynamic shared memory) the card can hold at once, into *out; 0
// when such a cluster cannot be scheduled.
template <typename... Params>
inline cudaError_t max_active_clusters(void (*kernel)(Params...), int threads,
                                       int cluster_blocks, size_t smem, int* out) {
  *out = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (cluster_blocks > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster_blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster_blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// Blocks of threads threads and smem bytes of dynamic shared memory that an SM
// of this card holds at once, from the build's registers and the card's
// limits (the CUDA runtime's occupancy calculator), into *out.
template <typename... Params>
inline cudaError_t max_active_blocks(void (*kernel)(Params...), int threads, size_t smem,
                                     int* out) {
  *out = 0;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, smem);
}

// Registers per thread, local-memory (spill) bytes per thread and the most
// threads a block of kernel can have with those registers, into out[0..2].
template <typename... Params>
inline cudaError_t resources(void (*kernel)(Params...), int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = attr.maxThreadsPerBlock;
  return err;
}

}  // namespace resident_loop
