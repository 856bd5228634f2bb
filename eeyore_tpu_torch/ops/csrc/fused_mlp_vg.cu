// Fused log-posterior and gradient of a sigmoid MLP for C chains at once.
//
// Replaces the Pallas TPU kernel eeyore_tpu/ops/fused_mlp.py::
// make_fused_log_target_vg (its math body is eeyore_tpu/ops/mlp_math.py::
// make_vg; the plain PyTorch version is eeyore_tpu_torch/ops/mlp_math.py::
// make_vg). For every chain c it computes
//   val[c]       = T * (log_lik(theta[c]) + log_prior(theta[c]))
//   grad[c, :]   = d val[c] / d theta[c]
// with BCE (sigmoid output) or softmax CE (logit output) and an IID Normal
// prior, by a forward pass, the output deltas and a hand-derived backward
// pass over the data rows.
//
// Design.
// - FUSED_LANES lanes of a warp a chain (lane_eval.cuh): lane l runs the
//   forward and backward pass of mlp_vg.cuh on the staged rows l, l +
//   FUSED_LANES, ... (LaneStagedEval::vg, the evaluator of the staged HMC and
//   NUTS kernels), the log-likelihood sums by xor butterflies and the
//   gradient is reduce-scattered onto the lanes that own its coordinates
//   (coordinate k FUSED_LANES + l on lane l). One thread a chain walked all
//   150 iris rows serially, forward and backward, with 8 warps an SM at 32768
//   chains: the kernel is bound by latency, and lanes give an SM more warps
//   and each warp fewer rows. The launch bounds (FUSED_MIN_BLOCKS blocks of
//   kBlockThreads an SM) cap the registers. On the H100 iris's 32768 chains
//   took 0.0506 ms a launch on 4 lanes at 2 blocks of 256 an SM (111
//   registers), 0.0520 on 2, 0.0527 on 8, against 0.0759 for the one-thread
//   kernel on [P, C] (ops/fused_mlp.py::FUSED_LANES, scripts/lane_sweep.py,
//   PERF.md); at 131072 chains, where one thread a chain already holds 32
//   warps an SM, the lanes gained 7%. FUSED_LANES = 1 is one thread a
//   chain (mlp_vg.cuh::chain_vg, theta, gradient and a row's activations in
//   registers, no launch bounds beyond the block size), which
//   ops/fused_mlp.py::fused_lanes takes on fewer than
//   resident_hmc.LANE_MIN_ROWS padded rows (XOR's 8, the 10-row deep case),
//   where a lane would get next to no rows.
// - Layout. theta and the gradient are [C, P], as the caller holds them
//   (make_fused_log_target_vg takes and returns them so, with no copy): a
//   chain's lanes read its coordinates, and write its gradient's, at
//   consecutive addresses, a warp's chains one after another; on lanes,
//   LaneStagedEval gathers theta whole through the chain's slot of P floats
//   in shared memory. The value goes to val[c] from the chain's lane 0.
//   Staging a block's rows of theta and of the gradient through a
//   shared-memory tile, coalesced, ran 7-17% slower on XOR's one-thread
//   build (its index arithmetic and two more passes over the tile against a
//   chain's 4 rows) and within 3% on iris's lanes (PERF.md, section 6).
// - Any C: the launch takes ceil(C lanes / threads) blocks; the chains past
//   C leave as a whole (a chain's lanes share its c, and every shuffle takes
//   the chain's lane mask), after the block's one barrier (stage_data).
//   ops/fused_mlp.py::fused_threads takes the largest block (128 threads on
//   one thread a chain, 256 on lanes) where that gives every SM two blocks
//   or more, else the block whose busiest SM holds the fewest threads.
// - The architecture is fixed at compile time (FMV_* macros in mlp_vg.cuh),
//   so every loop over units unrolls. x, y, the row mask and the prior
//   constants are staged once a block in shared memory (stage_data), where
//   the threads reading one word get a broadcast.
//
// Bound. Per chain the kernel reads P floats and writes P + 1; the data is
// read once a block. For a row it does about 2*P + (sum of layer widths)
// multiply-adds of the forward and backward passes and one or two
// transcendental calls per unit, so for iris-sized data (150 rows) it does
// thousands of operations per byte it moves: it is bound by operations, and
// among them by the special-function unit's exp/log throughput. f32
// throughout, with expf, logf and log1pf and no fast-math intrinsics.

#include "lane_eval.cuh"

#if !defined(FUSED_LANES) || !defined(FUSED_MIN_BLOCKS)
#error "FUSED_LANES (lanes a chain) and FUSED_MIN_BLOCKS must be defined"
#endif

using namespace mlp_vg;

namespace {

constexpr int kLanes = FUSED_LANES;
using FusedLanes = lane_eval::Lanes<kLanes>;
// The most threads a block of a launch takes: 128 on one thread a chain, 256
// on lanes (the fastest blocks of scripts/lane_sweep.py --kernels fused).
constexpr int kBlockThreads = kLanes == 1 ? 128 : 256;

#if FUSED_LANES == 1
#define FUSED_LAUNCH_BOUNDS __launch_bounds__(kBlockThreads)
#else
#define FUSED_LAUNCH_BOUNDS __launch_bounds__(kBlockThreads, FUSED_MIN_BLOCKS)
#endif

__global__ void FUSED_LAUNCH_BOUNDS
fused_mlp_vg_kernel(const float* __restrict__ theta,  // [C, P]
                    const float* __restrict__ x,      // [n_rows, kIn]
                    const float* __restrict__ y,      // [n_rows, kOut]
                    const float* __restrict__ mask,   // [n_rows]
                    const float* __restrict__ loc,    // [P]
                    const float* __restrict__ ivar,   // [P]
                    float prior_const, float temperature, int n_rows, int C,
                    float* __restrict__ val,          // [C]
                    float* __restrict__ grad) {       // [C, P]
  extern __shared__ float smem[];
  const Data d = stage_data(smem, x, y, mask, loc, ivar, n_rows);
  const int c = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / kLanes);
  if (c >= C) return;  // a chain's lanes leave together; no block barrier follows
  const float* th_c = theta + static_cast<size_t>(c) * kP;
  float* g_c = grad + static_cast<size_t>(c) * kP;
#if FUSED_LANES == 1
  float th[kP];
  float g[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) th[p] = th_c[p];
  const float v = chain_vg(th, d, prior_const, temperature, n_rows, g);
#pragma unroll
  for (int p = 0; p < kP; ++p) g_c[p] = g[p];
  val[c] = v;
#else
  const FusedLanes ln;
  const lane_eval::LaneStagedEval<FusedLanes> ev{
      d, prior_const, temperature, n_rows, ln,
      smem + data_floats(n_rows) + kP * (threadIdx.x / kLanes)};
  float th[FusedLanes::kPer];
  float g[FusedLanes::kPer];
#pragma unroll
  for (int k = 0; k < FusedLanes::kPer; ++k) th[k] = ln.coord(k) < kP ? th_c[ln.coord(k)] : 0.0f;
  const float v = ev.vg(th, g);
#pragma unroll
  for (int k = 0; k < FusedLanes::kPer; ++k) {
    if (ln.coord(k) < kP) g_c[ln.coord(k)] = g[k];
  }
  if (ln.lane == 0) val[c] = v;
#endif
}

size_t smem_bytes(int threads, int n_rows) {
  // on lanes, a gather slot of kP floats a chain
  const size_t chain_floats = kLanes == 1 ? 0 : kP;
  return sizeof(float) *
         (data_floats(n_rows) + static_cast<size_t>(threads / kLanes) * chain_floats);
}

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int fused_mlp_vg_arch(int* out) {
  // num_params, input width, output width, cross-entropy flag, most threads a block
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  out[4] = kBlockThreads;
  return 0;
}

// Lanes a chain.
extern "C" int fused_mlp_vg_lanes() { return kLanes; }

extern "C" int fused_mlp_vg_resources(int* out) {
  // registers per thread, local-memory (spill) bytes per thread, and the
  // most threads a block of this build can launch with those registers
  return static_cast<int>(resident_loop::resources(fused_mlp_vg_kernel, out));
}

// Blocks of threads threads an SM holds at once, for n_rows staged rows.
extern "C" int fused_mlp_vg_max_blocks(int threads, int n_rows, int* out) {
  return static_cast<int>(resident_loop::max_active_blocks(fused_mlp_vg_kernel, threads,
                                                           smem_bytes(threads, n_rows), out));
}

extern "C" const char* fused_mlp_vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int fused_mlp_vg_launch(const float* theta, const float* x, const float* y,
                                   const float* mask, const float* loc, const float* ivar,
                                   float prior_const, float temperature, int n_rows, int C,
                                   int threads, float* val, float* grad, void* stream) {
  if (threads < 32 || threads > kBlockThreads || threads % 32 != 0 || C < 1 || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long lanes = static_cast<long long>(C) * kLanes;
  const int blocks = static_cast<int>((lanes + threads - 1) / threads);
  return static_cast<int>(resident_loop::launch(
      fused_mlp_vg_kernel, blocks, threads, smem_bytes(threads, n_rows), 1, stream, theta, x,
      y, mask, loc, ivar, prior_const, temperature, n_rows, C, val, grad));
}
