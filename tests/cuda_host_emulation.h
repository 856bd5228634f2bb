// Host emulation of the CUDA primitives that the port's lane kernels use, for
// tests/test_torch_lane_emulation.py: a kernel source of
// eeyore_tpu_torch/ops/csrc compiles for the host with g++ against this header
// (its shared memory made static by the test), every thread of a block runs
// as a ucontext coroutine on one host thread, and warp shuffles, ballots,
// __syncwarp and __syncthreads are barriers over the lanes of their mask or
// over the block, at which a thread yields until every member has arrived.
// Blocks run one after another; clusters are refused. Only the primitives the
// kernels call are here.
#pragma once
#include <ucontext.h>
#include <math.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <utility>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }

inline dim3 threadIdx, blockIdx, blockDim, gridDim;

inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }

namespace emu {
struct Bar { int arrived = 0; long gen = 0; };
inline std::map<std::pair<long, unsigned>, Bar> bars;
inline std::vector<ucontext_t> ctx;
inline std::vector<char> done;
inline ucontext_t main_ctx;
inline int cur = 0;
inline float vals[1024];
inline unsigned bits[1024];
inline void yield() { swapcontext(&ctx[cur], &main_ctx); }
inline void barrier(long key, unsigned mask, int count) {
  Bar& b = bars[{key, mask}];
  const long g = b.gen;
  if (++b.arrived == count) {
    b.arrived = 0;
    b.gen++;
  } else {
    while (b.gen == g) yield();
  }
}
inline int warp() { return static_cast<int>(threadIdx.x) / 32; }
inline int lane() { return static_cast<int>(threadIdx.x) % 32; }
inline void warp_barrier(unsigned mask) { barrier(warp(), mask, __builtin_popcount(mask)); }
inline std::function<void()> body;
inline void entry() {
  body();
  done[cur] = 1;
  swapcontext(&ctx[cur], &main_ctx);
}
inline void run_block(int threads, std::function<void()> fn) {
  static std::vector<std::vector<char>> stacks;
  body = fn;
  ctx.assign(threads, ucontext_t{});
  done.assign(threads, 0);
  stacks.resize(threads);
  for (int t = 0; t < threads; ++t) {
    stacks[t].resize(1 << 20);
    getcontext(&ctx[t]);
    ctx[t].uc_stack.ss_sp = stacks[t].data();
    ctx[t].uc_stack.ss_size = stacks[t].size();
    ctx[t].uc_link = nullptr;
    makecontext(&ctx[t], entry, 0);
  }
  int left = threads;
  long passes = 0;
  while (left > 0) {
    for (int t = 0; t < threads; ++t) {
      if (done[t]) continue;
      cur = t;
      threadIdx = dim3(t);
      swapcontext(&main_ctx, &ctx[t]);
      if (done[t]) --left;
    }
    if (++passes > 2000000000L) {
      std::fprintf(stderr, "emulation: the block's threads wait on each other\n");
      std::abort();
    }
  }
  bars.clear();
}
}  // namespace emu

inline float __shfl_sync(unsigned mask, float v, int src, int width = 32) {
  const int l = emu::lane();
  emu::vals[threadIdx.x] = v;
  emu::warp_barrier(mask);
  const int s = (l & ~(width - 1)) + (src & (width - 1));
  const float r = emu::vals[emu::warp() * 32 + s];
  emu::warp_barrier(mask);
  return r;
}
inline float __shfl_xor_sync(unsigned mask, float v, int o, int width = 32) {
  const int l = emu::lane();
  return __shfl_sync(mask, v, (l ^ o) & (width - 1), width);
}
inline unsigned __ballot_sync(unsigned mask, bool p) {
  emu::bits[threadIdx.x] = p ? 1u : 0u;
  emu::warp_barrier(mask);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) {
    if ((mask >> i) & 1u) r |= emu::bits[emu::warp() * 32 + i] << i;
  }
  emu::warp_barrier(mask);
  return r;
}
inline void __syncwarp(unsigned mask = 0xffffffffu) { emu::warp_barrier(mask); }
inline void __syncthreads() { emu::barrier(-1, 0, static_cast<int>(blockDim.x)); }
inline unsigned __activemask() { return 0xffffffffu; }
inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
  unsigned s = 0;
  emu::bits[threadIdx.x] = v;
  emu::warp_barrier(mask);
  for (int i = 0; i < 32; ++i) if ((mask >> i) & 1u) s += emu::bits[emu::warp() * 32 + i];
  emu::warp_barrier(mask);
  return s;
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const auto o = *p; *p += v; return o;
}

// runtime API, enough for the launch code
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidConfiguration = 9;
constexpr cudaError_t cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream;
  cudaLaunchAttribute* attrs; unsigned numAttrs;
};
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; int maxThreadsPerBlock; };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0; a->localSizeBytes = 0; a->maxThreadsPerBlock = 1024; return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* o, F, const cudaLaunchConfig_t*) {
  *o = 1;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* o, F, int, size_t) {
  *o = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated error"; }
inline float emu_smem[1 << 22];
template <typename... Params, typename... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Params...),
                               Args... args) {
  for (unsigned i = 0; i < cfg->numAttrs; ++i) {
    if (cfg->attrs[i].val.clusterDim.x > 1) {
      std::fprintf(stderr, "emulation: no clusters\n");
      return 1;
    }
  }
  gridDim = cfg->gridDim;
  blockDim = cfg->blockDim;
  for (unsigned b = 0; b < cfg->gridDim.x; ++b) {
    blockIdx = dim3(b);
    emu::run_block(static_cast<int>(cfg->blockDim.x), [&]() { kernel(args...); });
  }
  return cudaSuccess;
}

namespace cooperative_groups {
struct cluster_group {
  void sync() {}
  template <class T> T* map_shared_rank(T* p, unsigned) { return p; }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
