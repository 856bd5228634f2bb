// The whole random-walk MH, MALA or blocked-Gibbs loop for C chains of a
// sigmoid MLP in one kernel, on data staged in shared memory.
//
// Replaces the MH, MALA, Gibbs and tempering moves of the Pallas TPU kernel
// eeyore_tpu/ops/resident_walk.py:166 (_make_resident, behind
// make_resident_mh :251, make_resident_mala :212, make_resident_gibbs :281
// and eeyore_tpu/ops/resident_tempering.py:178); the plain PyTorch versions
// are the CPU branches of eeyore_tpu_torch/ops/resident_walk.py. The loops
// are lane_eval.cuh::walk_chain and tempering_chain and resident_loop.cuh::
// gibbs_chain, shared with resident_walk_dense.cu; one library holds the four moves for one
// architecture and one Gibbs blocking (move 0: MH, on the value-only body,
// no backward pass; move 1: MALA, on the value and gradient; move 2: Gibbs,
// a sweep over the sub-blocks of the generated gibbs_blocks.cuh, value only;
// move 3: power-posterior tempering, MH or MALA within each rung by the
// template flag kMALA, with even/odd swaps of adjacent rungs). These kernels
// have no tuner, as the TPU's have none: chains share nothing but a
// tempering ladder, and a block is any 32-multiple of threads (for
// tempering, one that holds whole ladders and divides the chains).
//
// Gibbs. The TPU kernel keeps a per-chain cache of the activations of every
// data row and recomputes only the moved unit and what lies downstream. On
// iris that cache is 4.8 KB a chain, which no thread can hold, so the Gibbs
// move gives a chain GibbsBlocks::kLanes lanes of a warp (lane_eval.cuh),
// each caching the hidden activations of its own rows in registers: on iris
// MLP(4,3,2,3) at 32 lanes, 5 rows x 5 floats a lane. The generated
// gibbs_blocks.cuh says whether the cache fits a lane's budget
// (GibbsBlocks::kCached, ops/resident_walk.py::gibbs_lane_plan); a model
// over it evaluates each proposal by a whole value-only forward pass on the
// same lanes, the same function at more work.
//
// Design. MH and MALA: WALK_LANES lanes of a warp a chain (lane_eval.cuh),
// lane l owning the coordinates l, l + WALK_LANES, ... of the accepted theta
// (and gradient, MALA), the proposal (and its gradient) and z, all in
// registers; each evaluation gathers theta through the chain's slot in
// shared memory and runs the lane's rows l, l + WALK_LANES, ... (MH: the
// forward pass alone, LaneStagedEval::v; MALA: forward and backward, the
// gradient reduce-scattered onto the owners); the value, |z|^2, the
// reverse-proposal norm and the moved flag reduce by xor butterflies, so
// every lane takes the same accept decision; the 15 Threefry words of an
// iteration (on iris) are spread over the lanes; the record goes through a
// shared-memory tile of the block's chains. The chains share nothing, so a
// block is 256 threads, of which WALK_MIN_BLOCKS must fit an SM (the launch
// bounds that cap the registers: the moves are bound by latency, so resident
// warps pay; on iris 8 lanes at 2 blocks an SM, 128 registers and no spill,
// ran fastest over both moves; ops/resident_walk.py::WALK_LANES,
// scripts/lane_sweep.py, PERF.md). WALK_LANES = 1 is one thread a chain: the accepted
// theta (and gradient) in shared memory at [P][blockDim] beside the data
// rows, no launch bounds (ops/resident_walk.py::chain_lanes takes it for data
// of few rows). Tempering: TEMPERING_LANES lanes a chain, the within move as
// MH's and MALA's on lanes, a swap round through each chain's post in shared
// memory (lane_eval.cuh::tempering_chain); a block of at most 256 threads
// holds whole ladders, of which TEMPERING_MIN_BLOCKS must fit an SM, so a
// ladder longer than 256 / TEMPERING_LANES rungs takes a build of fewer
// lanes, down to one thread a chain (no launch bounds, blocks of up to 1024
// threads) for a ladder of 256 rungs (ops/resident_walk.py::tempering_lanes).
// Gibbs: kLanes lanes a chain, theta whole in every lane's registers, the
// sweep's draws spread over the lanes, the record through a shared-memory
// tile. A launch on lanes covers the chains exactly (blocks = C lanes /
// threads).
//
// Bound. One evaluation per chain and iteration (value only for MH), plus
// ceil(P/2) + 1 Threefry calls and ceil(P/2) Box-Muller pairs, plus kept x
// rows x C x 4 bytes of samples. On iris the evaluation dominates: bound by
// operations (the special-function unit). Gibbs: one evaluation per
// sub-block, counted for the bound at the TPU kernel's incremental work.

#include "lane_eval.cuh"
#include "gibbs_blocks.cuh"

#if !defined(WALK_LANES) || !defined(WALK_MIN_BLOCKS) || !defined(TEMPERING_LANES) || \
    !defined(TEMPERING_MIN_BLOCKS)
#error "WALK_LANES and TEMPERING_LANES (lanes a chain of MH and MALA and of the ladder move) \
and WALK_MIN_BLOCKS and TEMPERING_MIN_BLOCKS must be defined"
#endif

using namespace mlp_vg;
using resident_loop::kMaxThreads;

namespace {

// MH and MALA: lanes a chain, and the threads a block may have (the chains
// share nothing: on lanes 256, of which WALK_MIN_BLOCKS blocks fit an SM).
constexpr int kWalkLanes = WALK_LANES;
using WalkLanes = lane_eval::Lanes<kWalkLanes>;
constexpr int kWalkThreads = kWalkLanes == 1 ? kMaxThreads : 256;

#if WALK_LANES == 1
#define WALK_LAUNCH_BOUNDS
#else
#define WALK_LAUNCH_BOUNDS __launch_bounds__(kWalkThreads, WALK_MIN_BLOCKS)
#endif

// The ladder move: lanes a chain, and the threads a block may have (on lanes
// 256, of which TEMPERING_MIN_BLOCKS blocks fit an SM).
constexpr int kTemperingLanes = TEMPERING_LANES;
using TemperingLanes = lane_eval::Lanes<kTemperingLanes>;
constexpr int kTemperingThreads = kTemperingLanes == 1 ? kMaxThreads : 256;

#if TEMPERING_LANES == 1
#define TEMPERING_LAUNCH_BOUNDS
#else
#define TEMPERING_LAUNCH_BOUNDS __launch_bounds__(kTemperingThreads, TEMPERING_MIN_BLOCKS)
#endif

// The Gibbs move's lanes and evaluator (the cache, or the whole forward pass).
using GibbsLanes = lane_eval::Lanes<GibbsBlocks::kLanes>;
using GibbsEval =
    lane_eval::LaneGibbsEval<GibbsLanes, GibbsBlocks::kCached ? GibbsBlocks::kRowsPerLane : 0>;
using GibbsLayout = lane_eval::LaneGibbsLayout<GibbsLanes, GibbsBlocks>;

template <bool kMALA>
__global__ void WALK_LAUNCH_BOUNDS
    resident_walk_kernel(const float* __restrict__ theta0,  // [P, C]
                         const float* __restrict__ x, const float* __restrict__ y,
                         const float* __restrict__ mask,
                         const float* __restrict__ loc,
                         const float* __restrict__ ivar, const ResidentWalkParams pr,
                         float* __restrict__ samples,      // [kept, rows, C]
                         float* __restrict__ final_theta,  // [P, C]
                         float* __restrict__ accepts) {    // [C]
  extern __shared__ float smem[];
  const Data d = stage_data(smem, x, y, mask, loc, ivar, pr.n_rows);
  float* buf = smem + data_floats(pr.n_rows);
#if WALK_LANES == 1  // buf: the accepted theta and (MALA) its gradient, [P][bd] each
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= pr.num_chains) return;  // untuned: no block reduction follows
  const resident_loop::StagedEval ev{d, pr.prior_const, pr.temperature, pr.n_rows};
  lane_eval::walk_chain<kMALA>(ev, WalkLanes{}, pr, c, 1, theta0, samples, final_theta, accepts,
                               buf, nullptr, nullptr);
#else  // buf: a theta slot [P] per chain, then the record tile
  // the launch covers the chains exactly: every thread reaches the record's barriers
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / kWalkLanes;
  const WalkLanes ln;
  const lane_eval::LaneStagedEval<WalkLanes> ev{d, pr.prior_const, pr.temperature, pr.n_rows,
                                                ln, buf + kP * (threadIdx.x / kWalkLanes)};
  buf += static_cast<size_t>(kP) * (blockDim.x / kWalkLanes);
  lane_eval::walk_chain<kMALA>(ev, ln, pr, c, 1, theta0, samples, final_theta, accepts, buf,
                               nullptr, nullptr);
#endif
}

// at most kGibbsThreads threads a block (ops/resident_hmc_dense.py::
// UNGROUPED_BLOCK: the chains share nothing), of which GibbsBlocks::kMinBlocks
// blocks fit an SM
constexpr int kGibbsThreads = 256;

__global__ void __launch_bounds__(kGibbsThreads, GibbsBlocks::kMinBlocks)
    resident_walk_gibbs_kernel(const float* __restrict__ theta0,  // [P, C]
                               const float* __restrict__ x,
                               const float* __restrict__ y,
                               const float* __restrict__ mask,
                               const float* __restrict__ loc,
                               const float* __restrict__ ivar,
                               const float* __restrict__ scales,  // [kB]
                               const ResidentWalkParams pr,
                               float* __restrict__ samples,      // [kept, rows, C]
                               float* __restrict__ final_theta,  // [P, C]
                               float* __restrict__ accepts) {    // [kB, C]
  extern __shared__ float smem[];
  const Data d = stage_data(smem, x, y, mask, loc, ivar, pr.n_rows);
  // the launch covers the chains exactly: every thread reaches the record's barriers
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / GibbsBlocks::kLanes;
  const GibbsLanes ln;
  const GibbsEval ev{d, pr.prior_const, pr.temperature, pr.n_rows, ln};
  resident_loop::gibbs_chain<GibbsEval, GibbsBlocks>(
      ev, pr, c, theta0, scales, samples, final_theta, accepts,
      GibbsLayout{ln, smem + data_floats(pr.n_rows)});
}

template <bool kMALA>
__global__ void TEMPERING_LAUNCH_BOUNDS
    resident_walk_tempering_kernel(const float* __restrict__ theta0,  // [P, C]
                                   const float* __restrict__ x, const float* __restrict__ y,
                                   const float* __restrict__ mask,
                                   const float* __restrict__ loc,
                                   const float* __restrict__ ivar,
                                   const float* __restrict__ temps,  // [L]
                                   const ResidentWalkParams pr,
                                   float* __restrict__ samples,      // [kept, rows, C]
                                   float* __restrict__ final_theta,  // [P, C]
                                   float* __restrict__ accepts) {    // [2, C]
  extern __shared__ float smem[];
  const Data d = stage_data(smem, x, y, mask, loc, ivar, pr.n_rows);
  float* buf = smem + data_floats(pr.n_rows);
  // the blocks divide the chains' threads: every thread reaches every barrier
#if TEMPERING_LANES == 1  // buf: the ladder state, [P][bd] each
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const resident_loop::StagedEval ev{d, pr.prior_const, pr.temperature, pr.n_rows};
  lane_eval::tempering_chain<kMALA>(ev, TemperingLanes{}, pr, c, theta0, temps, samples,
                                    final_theta, accepts, buf);
#else  // buf: a theta slot [P] per chain, then the posts and the record tile
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / kTemperingLanes;
  const TemperingLanes ln;
  const int chains = blockDim.x / kTemperingLanes;
  const lane_eval::LaneStagedEval<TemperingLanes> ev{
      d, pr.prior_const, pr.temperature, pr.n_rows, ln, buf + kP * (threadIdx.x / kTemperingLanes)};
  lane_eval::tempering_chain<kMALA>(ev, ln, pr, c, theta0, temps, samples, final_theta, accepts,
                                    buf + static_cast<size_t>(kP) * chains);
#endif
}

size_t tempering_smem_bytes(bool mala, int n_rows, int threads, bool extras) {
  const size_t slots =
      kTemperingLanes == 1 ? 0 : static_cast<size_t>(kP) * (threads / kTemperingLanes);
  return sizeof(float) *
         (data_floats(n_rows) + slots +
          lane_eval::tempering_lane_floats(mala, extras, kTemperingLanes, threads));
}

size_t smem_bytes(int move, int n_rows, int threads) {
  if (move == 2) {  // Gibbs: theta in registers, the record tile
    return sizeof(float) *
           (data_floats(n_rows) + lane_eval::tile_floats(GibbsBlocks::kLanes, threads));
  }
  if (kWalkLanes > 1) {  // a theta slot per chain, the record tile
    return sizeof(float) *
           (data_floats(n_rows) + static_cast<size_t>(kP) * (threads / kWalkLanes) +
            lane_eval::walk_tile_floats(kWalkLanes, threads));
  }
  const int theta_copies = move == 1 ? 2 : 1;
  return sizeof(float) *
         (data_floats(n_rows) + theta_copies * static_cast<size_t>(kP) * threads);
}

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int resident_walk_arch(int* out) {
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  out[4] = kMaxThreads;
  return 0;
}

extern "C" int resident_walk_num_sub_blocks() { return GibbsBlocks::kB; }

// Lanes a chain of the MH and MALA moves, and of the ladder move.
extern "C" int resident_walk_lanes() { return kWalkLanes; }
extern "C" int resident_walk_tempering_lanes() { return kTemperingLanes; }

// Blocks of the ladder move (mala: within-rung MALA, else MH) of threads
// threads an SM holds at once, for n_rows staged rows.
extern "C" int resident_walk_tempering_max_blocks(int mala, int threads, int n_rows, int extras,
                                                  int* out) {
  const size_t smem = tempering_smem_bytes(mala != 0, n_rows, threads, extras != 0);
  return static_cast<int>(
      mala ? resident_loop::max_active_blocks(resident_walk_tempering_kernel<true>, threads, smem,
                                              out)
           : resident_loop::max_active_blocks(resident_walk_tempering_kernel<false>, threads,
                                              smem, out));
}

// Blocks of the MH (move 0) or MALA (move 1) kernel of threads threads an SM
// holds at once, for n_rows staged rows.
extern "C" int resident_walk_max_blocks(int move, int threads, int n_rows, int* out) {
  const size_t smem = smem_bytes(move, n_rows, threads);
  return static_cast<int>(
      move == 1 ? resident_loop::max_active_blocks(resident_walk_kernel<true>, threads, smem, out)
                : resident_loop::max_active_blocks(resident_walk_kernel<false>, threads, smem,
                                                   out));
}

// The Gibbs move's lanes a chain, whether it caches the rows' activations,
// and the rows a lane caches.
extern "C" int resident_walk_gibbs_layout(int* out) {
  out[0] = GibbsBlocks::kLanes;
  out[1] = GibbsBlocks::kCached ? 1 : 0;
  out[2] = GibbsBlocks::kRowsPerLane;
  out[3] = GibbsEval::kCache;
  return 0;
}

// Blocks of the Gibbs move of threads threads an SM holds at once, for n_rows
// staged rows.
extern "C" int resident_walk_gibbs_max_blocks(int threads, int n_rows, int* out) {
  return static_cast<int>(resident_loop::max_active_blocks(
      resident_walk_gibbs_kernel, threads, smem_bytes(2, n_rows, threads), out));
}

// move: 0 MH, 1 MALA, 2 Gibbs, 3 tempering with MH, 4 tempering with MALA.
extern "C" int resident_walk_resources(int move, int* out) {
  if (move == 2) return static_cast<int>(resident_loop::resources(resident_walk_gibbs_kernel, out));
  if (move == 3) {
    return static_cast<int>(resident_loop::resources(resident_walk_tempering_kernel<false>, out));
  }
  if (move == 4) {
    return static_cast<int>(resident_loop::resources(resident_walk_tempering_kernel<true>, out));
  }
  return static_cast<int>(move == 1 ? resident_loop::resources(resident_walk_kernel<true>, out)
                                    : resident_loop::resources(resident_walk_kernel<false>, out));
}

extern "C" const char* resident_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_walk_launch(int move, const float* theta0, const float* x,
                                    const float* y, const float* mask, const float* loc,
                                    const float* ivar, const ResidentWalkParams* params,
                                    int threads, float* samples, float* final_theta,
                                    float* accepts, void* stream) {
  const ResidentWalkParams pr = *params;
  const long long lanes = static_cast<long long>(pr.num_chains) * kWalkLanes;
  if (threads < 32 || threads > kWalkThreads || threads % 32 != 0 || pr.tuned ||
      (move != 0 && move != 1) || (kWalkLanes > 1 && lanes % threads != 0)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = smem_bytes(move, pr.n_rows, threads);
  const int blocks = static_cast<int>((lanes + threads - 1) / threads);
  const cudaError_t err =
      move == 1 ? resident_loop::launch(resident_walk_kernel<true>, blocks, threads, smem, 1,
                                        stream, theta0, x, y, mask, loc, ivar, pr, samples,
                                        final_theta, accepts)
                : resident_loop::launch(resident_walk_kernel<false>, blocks, threads, smem, 1,
                                        stream, theta0, x, y, mask, loc, ivar, pr, samples,
                                        final_theta, accepts);
  return static_cast<int>(err);
}

extern "C" int resident_walk_gibbs_launch(const float* theta0, const float* x, const float* y,
                                          const float* mask, const float* loc,
                                          const float* ivar, const float* scales,
                                          const ResidentWalkParams* params, int threads,
                                          float* samples, float* final_theta, float* accepts,
                                          void* stream) {
  const ResidentWalkParams pr = *params;
  const long long lanes = static_cast<long long>(pr.num_chains) * GibbsBlocks::kLanes;
  if (threads < 32 || threads > kGibbsThreads || threads % 32 != 0 || pr.tuned ||
      lanes % threads != 0 ||
      (GibbsBlocks::kCached && pr.n_rows > GibbsBlocks::kRowsPerLane * GibbsBlocks::kLanes)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = smem_bytes(2, pr.n_rows, threads);
  const int blocks = static_cast<int>(lanes / threads);
  return static_cast<int>(resident_loop::launch(resident_walk_gibbs_kernel, blocks, threads, smem,
                                                1, stream, theta0, x, y, mask, loc, ivar, scales,
                                                pr, samples, final_theta, accepts));
}

extern "C" int resident_walk_tempering_launch(int mala, const float* theta0, const float* x,
                                              const float* y, const float* mask,
                                              const float* loc, const float* ivar,
                                              const float* temps,
                                              const ResidentWalkParams* params, int threads,
                                              float* samples, float* final_theta,
                                              float* accepts, void* stream) {
  const ResidentWalkParams pr = *params;
  const long long lanes = static_cast<long long>(pr.num_chains) * kTemperingLanes;
  if (threads < 32 || threads > kTemperingThreads || threads % 32 != 0 || pr.tuned ||
      pr.num_rungs < 1 || threads % (pr.num_rungs * kTemperingLanes) != 0 ||
      lanes % threads != 0 || pr.between_step < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = tempering_smem_bytes(mala != 0, pr.n_rows, threads, pr.record_extras != 0);
  const int blocks = static_cast<int>(lanes / threads);
  const cudaError_t err =
      mala ? resident_loop::launch(resident_walk_tempering_kernel<true>, blocks, threads, smem, 1,
                                   stream, theta0, x, y, mask, loc, ivar, temps, pr, samples,
                                   final_theta, accepts)
           : resident_loop::launch(resident_walk_tempering_kernel<false>, blocks, threads, smem, 1,
                                   stream, theta0, x, y, mask, loc, ivar, temps, pr, samples,
                                   final_theta, accepts);
  return static_cast<int>(err);
}
