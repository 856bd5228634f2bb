// The whole HMC loop for C chains of a sigmoid MLP in one kernel.
//
// Replaces the Pallas TPU kernel eeyore_tpu/ops/resident_hmc.py:256
// (make_resident_hmc); the plain PyTorch version is the CPU branch of
// eeyore_tpu_torch/ops/resident_hmc.py. Per chain and iteration t: draw the
// momenta (kernel_prng.cuh, key (seed, chain), counter (t, j)), run
// num_steps leapfrog steps of the tempered log-posterior (mlp_vg.cuh), accept
// with probability min(1, exp(H_cur - H_prop)), count post-burn-in accepts
// and record every record_thin-th post-burn-in state. With a tuner, dual
// averaging runs on the mean acceptance rate of the chain block during
// burn-in (the l-rule sets num_steps), and the last burn-in iteration
// freezes the averaged step, as resident_hmc.py:184-218 does.
//
// Design.
// - One thread per chain; the tuning group is the CUDA block, one block per
//   chain_block chains. Its mean rate is a block reduction (warp shuffles,
//   then shared memory) that every thread finishes in the same order, so all
//   threads of a block apply the same tuner update.
// - The leapfrog trip count is a per-thread loop. The TPU kernel masks the
//   lanes whose trajectory ended (resident_hmc.py:149-158); a thread stops on
//   its own and gets the same numbers.
// - The proposal theta, momentum and gradient live in registers (3P floats
//   beside the value-and-gradient body's own); the accepted theta and
//   gradient, touched once per iteration, live in shared memory at
//   [P][blockDim] (2 * 27 * 4 B * 256 = 55 KB for iris, dynamic shared
//   memory above 48 KB), beside the data rows.
// - Samples are written chain-minor, [kept, rows, C] with rows = P (+2 with
//   record_extras: the value and the moved flag), so a warp's stores are
//   coalesced; the wrapper views them as [kept, C, P].
//
// Bound. num_iters x num_steps evaluations of the value and gradient (each
// bound by the special-function unit on iris, chip_smoke.py::vg_work), plus
// about 100 integer operations per Threefry call and ceil(P/2) + 1 calls
// per iteration, plus kept x P x C x 4 bytes of samples. On iris the
// evaluations dominate by orders of magnitude, so the kernel is bound by
// operations; on XOR, whose evaluation is a few hundred operations, the
// sample bytes and the PRNG weigh more.

#include "kernel_prng.cuh"
#include "mlp_vg.cuh"

// Scalar arguments, in the order of ResidentHMCParams in resident_hmc.py.
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
  float step;         // initial step
  float tuner_m;      // log(10 * step)
  float d, g, t0, k, l;
  float log_eub;      // +inf without an upper bound
  float prior_const;
  float temperature;
};

using namespace mlp_vg;

namespace {

constexpr int kMaxThreads = 1024;  // a tuning group is at most one block
constexpr int kPairs = (kP + 1) / 2;

// Mean of v over the block (blockDim.x a multiple of 32); every thread
// returns the same value.
__device__ __forceinline__ float block_mean(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warps = blockDim.x >> 5;
  __syncthreads();  // the previous iteration's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < warps; ++w) s += red[w];
  return s / static_cast<float>(blockDim.x);
}

__global__ void resident_hmc_kernel(const float* __restrict__ theta0,  // [P, C]
                                    const float* __restrict__ x, const float* __restrict__ y,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ loc,
                                    const float* __restrict__ ivar, const ResidentHMCParams pr,
                                    float* __restrict__ samples,      // [kept, rows, C]
                                    float* __restrict__ final_theta,  // [P, C]
                                    float* __restrict__ accepts) {    // [C]
  extern __shared__ float smem[];
  __shared__ float red[kMaxThreads / 32];
  const Data d = stage_data(smem, x, y, mask, loc, ivar, pr.n_rows);
  const int bd = blockDim.x;
  float* acc_th = smem + data_floats(pr.n_rows);  // accepted theta, [P][bd]
  float* acc_g = acc_th + kP * bd;                // its gradient, [P][bd]

  const int C = pr.num_chains;
  const int c = blockIdx.x * bd + threadIdx.x;
  // Only an untuned run has a ragged last block; a tuned block is full, so
  // every thread reaches the block reductions below.
  if (c >= C) return;
  const int rows = pr.record_extras ? kP + 2 : kP;
  const unsigned key0 = static_cast<unsigned>(pr.seed);
  const unsigned key1 = static_cast<unsigned>(c);

  float th[kP], g[kP], mom[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) th[p] = theta0[static_cast<size_t>(p) * C + c];
  float cur_val = chain_vg(th, d, pr.prior_const, pr.temperature, pr.n_rows, g);
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    acc_th[p * bd + threadIdx.x] = th[p];
    acc_g[p * bd + threadIdx.x] = g[p];
  }

  float n_accepts = 0.0f;
  float step = pr.step;
  int n_steps = pr.num_steps;
  float barh = 0.0f;
  float logbare = 0.0f;

  for (int t = 0; t < pr.num_iters; ++t) {
    const unsigned ctr = static_cast<unsigned>(t);
    float kin = 0.0f;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      float z0, z1;
      kernel_prng::normal2(kernel_prng::threefry2x32(key0, key1, ctr, j), &z0, &z1);
      mom[2 * j] = z0;
      if (2 * j + 1 < kP) mom[2 * j + 1] = z1;
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) kin += mom[p] * mom[p];
    const float h_cur = -cur_val + 0.5f * kin;

    // leapfrog from the accepted state
    const float half_step = 0.5f * step;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      th[p] = acc_th[p * bd + threadIdx.x];
      g[p] = acc_g[p * bd + threadIdx.x];
      mom[p] = mom[p] + half_step * g[p];
    }
    float val = cur_val;
    for (int s = 0; s < n_steps; ++s) {
#pragma unroll
      for (int p = 0; p < kP; ++p) th[p] = th[p] + step * mom[p];
      val = chain_vg(th, d, pr.prior_const, pr.temperature, pr.n_rows, g);
      const float f = (s == n_steps - 1 ? 0.5f : 1.0f) * step;
#pragma unroll
      for (int p = 0; p < kP; ++p) mom[p] = mom[p] + f * g[p];
    }
    float kin_prop = 0.0f;
#pragma unroll
    for (int p = 0; p < kP; ++p) kin_prop += mom[p] * mom[p];
    const float h_prop = -val + 0.5f * kin_prop;
    const float e = expf(h_cur - h_prop);
    const float rate = e > 1.0f ? 1.0f : e;  // NaN stays NaN and rejects
    const float u = kernel_prng::uniform(kernel_prng::threefry2x32(key0, key1, ctr, kPairs).x);
    bool moved = false;
    if (u < rate) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        moved |= th[p] != acc_th[p * bd + threadIdx.x];
        acc_th[p * bd + threadIdx.x] = th[p];
        acc_g[p * bd + threadIdx.x] = g[p];
      }
      cur_val = val;
      if (t >= pr.num_burnin_iters) n_accepts += 1.0f;
    }

    if (pr.tuned && t < pr.num_burnin_iters) {  // uniform over the block
      const float mean_rate = block_mean(rate, red);
      const float it = static_cast<float>(t + 1);
      const float d_w = 1.0f / (it + pr.t0);
      const float e_w = expf(-pr.k * logf(it));  // it ** -k
      barh = (1.0f - d_w) * barh + d_w * (pr.d - mean_rate);
      float loge = pr.tuner_m - sqrtf(it) * barh / pr.g;
      loge = loge > pr.log_eub ? pr.log_eub : loge;  // NaN stays NaN
      logbare = e_w * loge + (1.0f - e_w) * logbare;
      const bool last = t == pr.num_burnin_iters - 1;
      step = last ? expf(logbare) : expf(loge);
      const float ratio = pr.l / step;
      const float cap = static_cast<float>(pr.max_num_steps);
      n_steps = static_cast<int>(fminf(fmaxf(rintf(ratio), 1.0f), cap));
      if (pr.stochastic && last) {
        const float n_lo = floorf(ratio);
        const float ur =
            kernel_prng::uniform(kernel_prng::threefry2x32(key0, key1, ctr, kPairs + 1).x);
        const float n = n_lo + (ur < ratio - n_lo ? 1.0f : 0.0f);
        n_steps = static_cast<int>(fminf(fmaxf(n, 1.0f), cap));
      }
    }

    const int since = t - pr.num_burnin_iters;
    if (since >= 0 && since % pr.record_thin == 0 && since / pr.record_thin < pr.kept) {
      float* out = samples + static_cast<size_t>(since / pr.record_thin) * rows * C;
#pragma unroll
      for (int p = 0; p < kP; ++p) out[static_cast<size_t>(p) * C + c] = acc_th[p * bd + threadIdx.x];
      if (pr.record_extras) {
        out[static_cast<size_t>(kP) * C + c] = cur_val;
        out[static_cast<size_t>(kP + 1) * C + c] = moved ? 1.0f : 0.0f;
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kP; ++p) final_theta[static_cast<size_t>(p) * C + c] = acc_th[p * bd + threadIdx.x];
  accepts[c] = n_accepts;
}

}  // namespace

// Plain C interface, loaded with ctypes. Returns a cudaError_t code.

extern "C" int resident_hmc_arch(int* out) {
  // num_params, input width, output width, cross-entropy flag, max threads per block
  out[0] = kP;
  out[1] = kIn;
  out[2] = kOut;
  out[3] = kCrossEntropy ? 1 : 0;
  out[4] = kMaxThreads;
  return 0;
}

extern "C" int resident_hmc_resources(int* out) {
  // registers per thread, local-memory (spill) bytes per thread, and the
  // most threads a block of this build can launch with those registers
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, resident_hmc_kernel);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = attr.maxThreadsPerBlock;
  return static_cast<int>(err);
}

extern "C" const char* resident_hmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int resident_hmc_launch(const float* theta0, const float* x, const float* y,
                                   const float* mask, const float* loc, const float* ivar,
                                   const ResidentHMCParams* params, int threads,
                                   float* samples, float* final_theta, float* accepts,
                                   void* stream) {
  const ResidentHMCParams pr = *params;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem =
      sizeof(float) * (data_floats(pr.n_rows) + 2 * static_cast<size_t>(kP) * threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resident_hmc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((pr.num_chains + threads - 1) / threads);
  resident_hmc_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      theta0, x, y, mask, loc, ivar, pr, samples, final_theta, accepts);
  return static_cast<int>(cudaGetLastError());
}
