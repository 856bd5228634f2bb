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
//
// Design. MH, MALA and the ladder move (moves 0, 1 and 3) run
// lane_eval.cuh::walk_chain and tempering_chain on WALK_DENSE_LANES lanes of
// a warp a chain, a build's define: the maker of each move loads the build of
// its own lanes (ops/resident_walk_dense.py::WALK_DENSE_LANES, dense_lanes:
// never more lanes than data rows). A lane evaluates the generated lane body
// dense_lanes.cuh (ops/mlp_dense.py::dense_lane_source) on its own rows l,
// l + kLanes, ...: the rows' inputs and labels are registers loaded once
// from the lane's constants, everything else is folded as in the one-thread
// body, so every lane runs the same code and a warp issues one stream for
// its 32 / kLanes chains' rows; the evaluator (lane_eval.cuh::LaneDenseEval)
// posts theta to the chain's slot in shared memory and reads it back whole,
// sums the value by an xor butterfly and reduce-scatters the gradient onto
// the lanes that own its coordinates. The iteration's ceil(P/2) + 1 Threefry
// words (with the ladder's swap uniform) and Box-Muller pairs are spread
// over the lanes, the accepted state lives in registers, spread too, and
// each lane stores its owned coordinates of a record directly (a warp's 8
// or more consecutive chains fill whole sectors, lane_eval.cuh::
// record_lanes). A block's chains divide the sublane row's chain_block / 8
// (resident_loop.cuh::chain_index), so they are consecutive (a ladder's
// partner is the next slot), each chain keeps the TPU kernel's
// sublane-strided index and a tuning group its chains. The lanes give
// kLanes times the warps to hide the serial loop's latency for the price of
// the shuffles, the gather and the draws' rounding up to whole rounds: on
// XOR (the H100 sweep, PERF.md section 6) that pays for MALA (153 registers
// a thread left 8 warps an SM) and for the ladder's entry point (1024 chains
// on one thread a chain fill 32 SMs), not for MH, whose one-thread body of
// six independent Threefry words and four rows issues fewer instructions,
// so MH runs one thread a chain. Blocks are at most 256 threads
// (resident_walk_dense.py::WALK_DENSE_BLOCK), of which WALK_DENSE_MIN_BLOCKS
// must fit an SM (the launch bounds that cap the registers). A tuning group
// (chain_block chains) is a block or a cluster of up to 16 such blocks; a
// group that none holds on lanes, a ladder too long for a block, or data of
// one row, takes the build of one thread a chain (WALK_DENSE_LANES = 1: the
// accepted theta and gradient in shared memory at [P][blockDim], the
// one-thread body dense_body.cuh, no launch bounds), a rule decided before
// the launch (walk_dense_lanes, dense_tempering_lanes).
// gibbs_chain (move 2) runs one thread a chain in every build of a model
// with parameter blocks (GIBBS_MOVE of gibbs_blocks.cuh; none without them,
// as for LogisticRegression), on the
// generated incremental body dense_gibbs.cuh and the blocking
// gibbs_blocks.cuh: the
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
// evaluations. The lane body does not fold XOR's zero and unit inputs, which
// are registers: more operations than the bound counts, which is the
// function's (the folded body's).

#include "lane_eval.cuh"
#include "dense_body.cuh"
#include "gibbs_blocks.cuh"

#if !defined(WALK_DENSE_LANES) || !defined(WALK_DENSE_MIN_BLOCKS)
#error "WALK_DENSE_LANES (lanes a chain of MH, MALA and the ladder move) and \
WALK_DENSE_MIN_BLOCKS must be defined"
#endif
#if WALK_DENSE_LANES > 1
#include "dense_lanes.cuh"
#endif

using namespace mlp_vg;
using resident_loop::kMaxThreads;

static_assert(dense_body::kP == kP, "generated body and architecture disagree");

namespace {

// MH, MALA and the ladder move: lanes a chain, and the threads a block may
// have (on lanes 256, of which WALK_DENSE_MIN_BLOCKS blocks fit an SM).
constexpr int kWalkLanes = WALK_DENSE_LANES;
using WalkLanes = lane_eval::Lanes<kWalkLanes>;
constexpr int kWalkThreads = kWalkLanes == 1 ? kMaxThreads : 256;

#if WALK_DENSE_LANES == 1
#define WALK_DENSE_LAUNCH_BOUNDS
#else
static_assert(dense_body::kLanes == kWalkLanes, "generated lane body and build disagree");
#define WALK_DENSE_LAUNCH_BOUNDS __launch_bounds__(kWalkThreads, WALK_DENSE_MIN_BLOCKS)
using LaneEval = lane_eval::LaneDenseEval<WalkLanes, dense_body::LaneBody>;
#endif

struct DenseEval {
  __device__ __forceinline__ float vg(const float (&th)[kP], float (&g)[kP]) const {
    return dense_body::vg(th, g);
  }
  __device__ __forceinline__ float v(const float (&th)[kP]) const { return dense_body::v(th); }
};

template <bool kMALA>
__global__ void WALK_DENSE_LAUNCH_BOUNDS
    resident_walk_dense_kernel(const float* __restrict__ theta0,  // [P, C]
                               const ResidentWalkParams pr,
                               float* __restrict__ samples,      // [kept, rows, C]
                               float* __restrict__ final_theta,  // [P, C]
                               float* __restrict__ accepts,      // [C]
                               int cluster_blocks) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxThreads / 32];
  __shared__ float partial[2];
  const int c = resident_loop::chain_index(pr.sublanes, pr.chain_block, pr.num_chains,
                                           kWalkLanes);
#if WALK_DENSE_LANES == 1  // smem: the accepted theta and (MALA) its gradient, [P][bd] each
  lane_eval::walk_chain<kMALA>(DenseEval{}, WalkLanes{}, pr, c, cluster_blocks, theta0, samples,
                               final_theta, accepts, smem, red, partial);
#else  // smem: a theta slot [P] per chain, then the record tile
  // the launch covers the chains exactly: every thread reaches every barrier
  const WalkLanes ln;
  const LaneEval ev(ln, smem + kP * (threadIdx.x / kWalkLanes));
  lane_eval::walk_chain<kMALA>(ev, ln, pr, c, cluster_blocks, theta0, samples, final_theta,
                               accepts, smem + static_cast<size_t>(kP) * (blockDim.x / kWalkLanes),
                               red, partial);
#endif
  // no block of a cluster leaves while another may read its partial sum
  if (cluster_blocks > 1) cooperative_groups::this_cluster().sync();
}

template <bool kMALA>
__global__ void WALK_DENSE_LAUNCH_BOUNDS
    resident_walk_dense_tempering_kernel(const float* __restrict__ theta0,  // [P, C]
                                         const float* __restrict__ temps,   // [L]
                                         const ResidentWalkParams pr,
                                         float* __restrict__ samples,
                                         float* __restrict__ final_theta,  // [P, C]
                                         float* __restrict__ accepts) {    // [2, C]
  extern __shared__ float smem[];
  // the blocks divide the chains' threads: every thread reaches every barrier
  const int c = resident_loop::chain_index(pr.sublanes, pr.chain_block, pr.num_chains,
                                           kWalkLanes);
#if WALK_DENSE_LANES == 1  // smem: the ladder state, [P][bd] each
  lane_eval::tempering_chain<kMALA>(DenseEval{}, WalkLanes{}, pr, c, theta0, temps, samples,
                                    final_theta, accepts, smem);
#else  // smem: a theta slot [P] per chain, then the posts and the record tile
  const WalkLanes ln;
  const LaneEval ev(ln, smem + kP * (threadIdx.x / kWalkLanes));
  lane_eval::tempering_chain<kMALA>(ev, ln, pr, c, theta0, temps, samples, final_theta, accepts,
                                    smem + static_cast<size_t>(kP) * (blockDim.x / kWalkLanes));
#endif
}

// Floats of dynamic shared memory of the MH (move 0), MALA (1) and ladder
// (3: MH, 4: MALA within the rungs) kernels for a block of threads threads.
size_t smem_bytes(int move, int threads, bool extras) {
  const size_t slots = kWalkLanes == 1 ? 0 : static_cast<size_t>(kP) * (threads / kWalkLanes);
  if (move == 3 || move == 4) {
    return sizeof(float) *
           (slots + lane_eval::tempering_lane_floats(move == 4, extras, kWalkLanes, threads));
  }
  if (kWalkLanes > 1) {
    return sizeof(float) *
           (slots + lane_eval::walk_tile_floats(kWalkLanes, threads));
  }
  return sizeof(float) * (move == 1 ? 2 : 1) * static_cast<size_t>(kP) * threads;
}

// Whether blocks of threads threads lay out chain blocks of chain_block
// chains (sublanes a group): the group's threads split into whole blocks, and
// on lanes a block's chains divide the sublane row, so they are consecutive.
bool lays_out(int threads, const ResidentWalkParams& pr) {
  const long long group = static_cast<long long>(pr.chain_block) * kWalkLanes;
  const int chains = threads / kWalkLanes;
  return threads >= 32 && threads <= kWalkThreads && threads % 32 == 0 && group % threads == 0 &&
         pr.chain_block > 0 && pr.num_chains % pr.chain_block == 0 && pr.sublanes > 0 &&
         (kWalkLanes == 1 || (pr.chain_block / pr.sublanes) % chains == 0);
}

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

// ---- The Gibbs move (move 2) ----
// Only a model with parameter blocks has one (GIBBS_MOVE of the generated
// gibbs_blocks.cuh). Without them (LogisticRegression) the build holds no
// Gibbs kernel and no dense_gibbs.cuh: the Gibbs entry points below refuse
// and there are no sub-blocks.
#if GIBBS_MOVE
#include "dense_gibbs.cuh"

namespace {

// The dense body with the generated incremental Gibbs updates.
struct DenseGibbsEval : DenseEval {
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

__global__ void resident_walk_dense_gibbs_kernel(const float* __restrict__ theta0,  // [P, C]
                                                 const float* __restrict__ scales,  // [kB]
                                                 const ResidentWalkParams pr,
                                                 float* __restrict__ samples,  // [kept, rows, C]
                                                 float* __restrict__ final_theta,  // [P, C]
                                                 float* __restrict__ accepts) {    // [kB, C]
  const int c = resident_loop::chain_index(pr.sublanes, pr.chain_block, pr.num_chains);
  resident_loop::gibbs_chain<DenseGibbsEval, GibbsBlocks>(DenseGibbsEval{}, pr, c, theta0,
                                                          scales, samples, final_theta, accepts);
}

int gibbs_resources(int* out) {
  return static_cast<int>(resident_loop::resources(resident_walk_dense_gibbs_kernel, out));
}

}  // namespace

extern "C" int resident_walk_dense_num_sub_blocks() { return GibbsBlocks::kB; }

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

#else  // no Gibbs move

namespace {
int gibbs_resources(int*) { return static_cast<int>(cudaErrorInvalidConfiguration); }
}  // namespace

extern "C" int resident_walk_dense_num_sub_blocks() { return 0; }
extern "C" int resident_walk_dense_gibbs_launch(const float*, const float*,
                                                const ResidentWalkParams*, int, float*, float*,
                                                float*, void*) {
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

#endif  // GIBBS_MOVE

extern "C" int resident_walk_dense_arch(int* out) {
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  out[4] = kMaxThreads;
  return 0;
}

// Lanes a chain of the MH, MALA and ladder moves.
extern "C" int resident_walk_dense_lanes() { return kWalkLanes; }

// move: 0 MH, 1 MALA, 2 Gibbs, 3 tempering with MH, 4 tempering with MALA.
extern "C" int resident_walk_dense_resources(int move, int* out) {
  if (move == 2) return gibbs_resources(out);
  if (move == 3 || move == 4) {
    return static_cast<int>(
        move == 4 ? resident_loop::resources(resident_walk_dense_tempering_kernel<true>, out)
                  : resident_loop::resources(resident_walk_dense_tempering_kernel<false>, out));
  }
  return static_cast<int>(
      move == 1 ? resident_loop::resources(resident_walk_dense_kernel<true>, out)
                : resident_loop::resources(resident_walk_dense_kernel<false>, out));
}

// Blocks of the MH or MALA (move 0, 1) or ladder (3, 4) kernel of threads
// threads an SM holds at once.
extern "C" int resident_walk_dense_max_blocks(int move, int threads, int extras, int* out) {
  const size_t smem = smem_bytes(move, threads, extras != 0);
  if (move == 3 || move == 4) {
    return static_cast<int>(
        move == 4 ? resident_loop::max_active_blocks(resident_walk_dense_tempering_kernel<true>,
                                                     threads, smem, out)
                  : resident_loop::max_active_blocks(resident_walk_dense_tempering_kernel<false>,
                                                     threads, smem, out));
  }
  return static_cast<int>(
      move == 1
          ? resident_loop::max_active_blocks(resident_walk_dense_kernel<true>, threads, smem, out)
          : resident_loop::max_active_blocks(resident_walk_dense_kernel<false>, threads, smem,
                                             out));
}

extern "C" int resident_walk_dense_max_clusters(int move, int threads, int cluster_blocks,
                                                int* out) {
  const size_t smem = smem_bytes(move, threads, false);
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
  const long long group = static_cast<long long>(pr.chain_block) * kWalkLanes;
  // a tuning group is the block or the cluster
  if (!lays_out(threads, pr) || cluster_blocks < 1 ||
      cluster_blocks > resident_loop::kMaxCluster ||
      ((pr.tuned || cluster_blocks > 1) && cluster_blocks * threads != group) ||
      (move != 0 && move != 1)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = smem_bytes(move, threads, false);
  const int blocks = static_cast<int>(static_cast<long long>(pr.num_chains) * kWalkLanes / threads);
  const cudaError_t err =
      move == 1 ? resident_loop::launch(resident_walk_dense_kernel<true>, blocks, threads, smem,
                                        cluster_blocks, stream, theta0, pr, samples,
                                        final_theta, accepts, cluster_blocks)
                : resident_loop::launch(resident_walk_dense_kernel<false>, blocks, threads, smem,
                                        cluster_blocks, stream, theta0, pr, samples,
                                        final_theta, accepts, cluster_blocks);
  return static_cast<int>(err);
}

extern "C" int resident_walk_dense_tempering_launch(int mala, const float* theta0,
                                                    const float* temps,
                                                    const ResidentWalkParams* params,
                                                    int threads, float* samples,
                                                    float* final_theta, float* accepts,
                                                    void* stream) {
  const ResidentWalkParams pr = *params;
  // a block holds whole ladders, of chains along the sublane row
  if (!lays_out(threads, pr) || pr.tuned || pr.num_rungs < 1 ||
      threads % (pr.num_rungs * kWalkLanes) != 0 ||
      (pr.chain_block / pr.sublanes) % pr.num_rungs != 0 || pr.between_step < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = smem_bytes(mala ? 4 : 3, threads, pr.record_extras != 0);
  const int blocks = static_cast<int>(static_cast<long long>(pr.num_chains) * kWalkLanes / threads);
  const cudaError_t err =
      mala ? resident_loop::launch(resident_walk_dense_tempering_kernel<true>, blocks, threads,
                                   smem, 1, stream, theta0, temps, pr, samples, final_theta,
                                   accepts)
           : resident_loop::launch(resident_walk_dense_tempering_kernel<false>, blocks, threads,
                                   smem, 1, stream, theta0, temps, pr, samples, final_theta,
                                   accepts);
  return static_cast<int>(err);
}
