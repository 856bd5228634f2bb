// The SMC mutation pass of N particles of a log-density closure in one
// kernel, its value and gradient generated from the closure.
//
// Replaces the Pallas TPU kernel of
// eeyore_tpu/ops/resident_smc.py::make_resident_smc_mutation on a
// DistributionModel target (the pl.pallas_call of kernel_generic at :315,
// which interprets the closure's traced jaxpr inside the kernel); the plain
// PyTorch version is eeyore_tpu_torch/ops/resident_smc.py::
// _run_mutation_plain on make_generic_vg (the closure by batched autograd).
// The loop is resident_smc.cu's (lane_eval.cuh::smc_chain: the same moves,
// stream and step constants); what differs is the evaluation:
// - closure_body.cuh, which ops/closure_trace.py generates from the
//   closure's value and gradient traced for one particle (the build's name
//   carries its hash): straight-line f32 code, v(th) -> (ll, lp) and
//   vg(th, gll, glp) -> (ll, lp), with ll = log target - log base and lp =
//   log base, the geometric path of tempered SMC. The constants the closure
//   captures are literals of the code, as the dense kernels hold their data.
// - No data are staged.
// lane_eval.cuh takes the parameter count from mlp_vg.cuh's architecture
// macros: the build gives it a one-layer net without bias of P parameters
// (FMV_DIMS = in | out << 8, in * out = P), of which nothing else is used.
//
// Design. One thread a particle (lane_eval.cuh::smc_chain at Lanes<1> on
// ClosureEval): the accepted theta and, for MALA, its combined gradient beta
// * gll + glp in shared memory at [P][blockDim], blocks of SMC_BLOCK threads
// (ops/resident_smc.py), no launch bounds: the body of a small closure needs
// few registers. A particle's pass is a chain of dependent latencies (the
// step's Threefry words, Box-Muller, the body's exp and log, the accept
// test), with 4 warps an SM on 16384 particles. A particle on a group of
// lanes, every lane running the whole body with the step's words spread
// over the lanes, ran 16% (2 lanes) and 31% (4) slower; drawing each step's
// words during the step before gained 2%, too little for a second one-thread
// path through smc_chain (PERF.md, section 6).
//
// Bound. Per particle 1 + num_steps evaluations of the generated body
// (closure_trace.work counts its operations), and the walk stream's Threefry
// and Box-Muller work per step; bytes: theta read once, final, pot and
// counts written once. Bound by operations.

#include "lane_eval.cuh"
#include "closure_body.cuh"

using mlp_vg::kP;
using resident_loop::kMaxThreads;

static_assert(closure_body::kP == kP, "generated body and parameter count disagree");

namespace {

// The closure's SMC target lp + beta * ll on one thread, beta taken at run
// time (the interface of resident_loop::SplitEval).
struct ClosureEval {
  float beta;
  __device__ __forceinline__ float vg(const float (&th)[kP], float (&g)[kP], float& ll) const {
    float gll[kP];
    float glp[kP];
    const float2 s = closure_body::vg(th, gll, glp);
#pragma unroll
    for (int p = 0; p < kP; ++p) g[p] = glp[p] + beta * gll[p];
    ll = s.x;
    return s.y + beta * s.x;
  }
  __device__ __forceinline__ float v(const float (&th)[kP], float& ll) const {
    const float2 s = closure_body::v(th);
    ll = s.x;
    return s.y + beta * s.x;
  }
};

template <bool kMALA>
__global__ void resident_smc_closure_kernel(const float* __restrict__ theta0,  // [P, N]
                                            const ResidentSMCParams pr,
                                            float* __restrict__ final_theta,  // [P, N]
                                            float* __restrict__ pot,          // [N]
                                            float* __restrict__ accepts) {    // [N]
  extern __shared__ float smem[];
  // smem: the accepted theta and its combined gradient (MALA), [P][bd] each
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= pr.num_particles) return;  // no block barrier follows
  const ClosureEval ev{pr.beta};
  lane_eval::smc_chain<kMALA>(ev, lane_eval::Lanes<1>{}, pr, c, theta0, final_theta, pot,
                              accepts, smem);
}

size_t smem_bytes(bool mala, int threads) {
  return sizeof(float) * (mala ? 2 : 1) * static_cast<size_t>(kP) * threads;
}

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int resident_smc_closure_arch(int* out) {
  out[0] = kP;
  out[1] = kMaxThreads;
  return 0;
}

// move: 0 MH, 1 MALA.
extern "C" int resident_smc_closure_resources(int move, int* out) {
  return static_cast<int>(move == 1
                              ? resident_loop::resources(resident_smc_closure_kernel<true>, out)
                              : resident_loop::resources(resident_smc_closure_kernel<false>, out));
}

// Blocks of threads threads of the MH (move 0) or MALA (1) pass an SM holds
// at once.
extern "C" int resident_smc_closure_max_blocks(int move, int threads, int* out) {
  const size_t smem = smem_bytes(move == 1, threads);
  return static_cast<int>(
      move == 1
          ? resident_loop::max_active_blocks(resident_smc_closure_kernel<true>, threads, smem, out)
          : resident_loop::max_active_blocks(resident_smc_closure_kernel<false>, threads, smem,
                                             out));
}

extern "C" const char* resident_smc_closure_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_smc_closure_launch(int mala, const float* theta0,
                                           const ResidentSMCParams* params, int threads,
                                           float* final_theta, float* pot, float* accepts,
                                           void* stream) {
  const ResidentSMCParams pr = *params;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || pr.num_particles < 1 ||
      pr.num_steps < 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = smem_bytes(mala != 0, threads);
  const int blocks = (pr.num_particles + threads - 1) / threads;
  const cudaError_t err =
      mala ? resident_loop::launch(resident_smc_closure_kernel<true>, blocks, threads, smem, 1,
                                   stream, theta0, pr, final_theta, pot, accepts)
           : resident_loop::launch(resident_smc_closure_kernel<false>, blocks, threads, smem, 1,
                                   stream, theta0, pr, final_theta, pot, accepts);
  return static_cast<int>(err);
}
